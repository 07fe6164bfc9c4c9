"""Selection iterators (ref scheduler/select.go): bounded lookahead + max.
"""
from __future__ import annotations

from typing import Optional

from .rank import RankedNode, RankIterator

# ref scheduler/stack.go:10-18
SKIP_SCORE_THRESHOLD = 0.0
MAX_SKIP = 3


class LimitIterator(RankIterator):
    """Yield at most `limit` options, skipping up to MAX_SKIP low-scoring ones
    (ref select.go LimitIterator)."""

    def __init__(self, ctx, source: RankIterator, limit: int,
                 skip_threshold: float = SKIP_SCORE_THRESHOLD,
                 max_skip: int = MAX_SKIP):
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.skip_threshold = skip_threshold
        self.max_skip = max_skip
        self.scan_limit_reached = False
        self.seen = 0
        self.skipped: list[RankedNode] = []

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def next(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self.source.next()
        if option is None:
            return self._next_from_skipped()
        if not self.scan_limit_reached and \
           option.final_score <= self.skip_threshold and \
           len(self.skipped) < self.max_skip:
            self.skipped.append(option)
            if len(self.skipped) == self.max_skip:
                self.scan_limit_reached = True
            return self.next()
        self.seen += 1
        return option

    def _next_from_skipped(self) -> Optional[RankedNode]:
        if self.skipped:
            option = self.skipped.pop(0)
            self.seen += 1
            return option
        return None

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0
        self.skipped = []
        self.scan_limit_reached = False


class MaxScoreIterator(RankIterator):
    """Consume the source and return only the best option (ref select.go)."""

    def __init__(self, ctx, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.done = False

    def next(self) -> Optional[RankedNode]:
        if self.done:
            return None
        best: Optional[RankedNode] = None
        while True:
            option = self.source.next()
            if option is None:
                break
            if best is None or option.final_score > best.final_score:
                best = option
        self.done = True
        return best

    def reset(self) -> None:
        self.source.reset()
        self.done = False
