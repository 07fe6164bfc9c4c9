"""Raft consensus (ref hashicorp/raft as wired in nomad/server.go:1221
setupRaft; nomad/leader.go:56 monitorLeadership): leader election, log
replication, and FSM snapshots over the framework's RPC transport.

TPU-native design note (SURVEY.md §2.7): consensus is a DCN protocol between
control-plane hosts — deliberately independent of the JAX/ICI compute path.
The contract it keeps for the scheduler is the same as the single-node
``RaftLog``: ``apply()`` returns only after the message is durably committed
and visible in the local FSM at the returned index, and every replica applies
the identical message sequence (replay determinism; the scheduler's
snapshot-min-index barrier, nomad/worker.go:536, builds on this).

Persistence (checkpoint/resume, SURVEY.md §5; crash consistency, ISSUE
13): term/vote in a crc-enveloped metadata file, log entries in an
append-only WAL whose frames carry (index, term, crc32) headers, FSM
snapshots + log generations named by an atomically-replaced MANIFEST —
all through `server/durable.py` (fsync discipline, fault sites, torn-
write recovery: docs/DURABILITY.md). A restarted server restores its
FSM from the snapshot and reloads the log; entries past the snapshot
re-apply through the applier only as commitment is re-established (ref
raft-boltdb + fsm.go Snapshot/Restore; an ex-leader's unsynced tail may
be truncated by the next leader, so it must never be applied eagerly at
boot).
"""
from __future__ import annotations

import heapq
import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Optional

from .. import chrono
from ..metrics import metrics
from ..rpc.codec import FencedWriteError, LeadershipLostError, NotLeaderError

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

_CONFIG_TYPES = ("_config_add", "_config_remove")


class _Entry:
    __slots__ = ("term", "type", "payload")

    def __init__(self, term: int, type_: str, payload):
        self.term = term
        self.type = type_
        self.payload = payload


class _Proposal:
    """One queued apply() call riding the group-commit pipeline (ISSUE
    20). Acks are PER-PROPOSAL: `done` is set only on a terminal event
    for THIS proposal — staging failure (`error`), config append (those
    callers return at append), or its own index becoming applied — so a
    waiter never wakes for a batch-mate's progress (wake-by-index)."""
    __slots__ = ("msg_type", "payload", "fence", "index", "term",
                 "error", "appended", "done")

    def __init__(self, msg_type: str, payload, fence: Optional[int]):
        self.msg_type = msg_type
        self.payload = payload
        self.fence = fence
        self.index = 0
        self.term = 0
        self.error: Optional[BaseException] = None
        self.appended = False
        self.done = threading.Event()


class RaftNode:
    """One consensus participant. Peers are {server_id: rpc_addr}; the RPC
    handlers are registered on the server's RpcServer so Raft traffic shares
    the agent's single TCP listener (the reference multiplexes Raft on its
    RPC port the same way, nomad/rpc.go:341)."""

    def __init__(self, fsm, node_id: str, rpc_server, peers: dict[str, str],
                 data_dir: Optional[str] = None, logger=None,
                 election_timeout: tuple[float, float] = (0.4, 0.8),
                 heartbeat_interval: float = 0.1,
                 snapshot_threshold: int = 8192,
                 bootstrap: bool = True,
                 clock: Optional[chrono.Clock] = None,
                 seed: Optional[int] = None):
        self.fsm = fsm
        self.node_id = node_id
        # every timing DECISION (election deadlines, contact ages) reads
        # this clock; a chrono.ManualClock makes elections fire exactly
        # when a test advances time (ISSUE 6). Thread poll cadences stay
        # real — see chrono.py.
        self.clock = clock or chrono.REAL
        # election jitter from a private RNG: with an explicit seed the
        # campaign ORDER of a cluster is reproducible run to run (the
        # deterministic multi-server tests seed s0 < s1 < s2)
        self._rng = random.Random(seed) if seed is not None \
            else random.Random()
        # bootstrap=False: an expansion server (gossip auto-join, ref
        # bootstrap_expect) — it must NOT self-elect while its config is
        # the trivial {self}; it waits to be adopted by a leader's
        # _config_add and only then participates in elections
        self.bootstrap = bootstrap
        self.rpc_server = rpc_server
        self.addr = rpc_server.addr
        self.logger = logger or (lambda msg: None)
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.snapshot_threshold = snapshot_threshold
        self.data_dir = data_dir
        self._durable = None
        if data_dir:
            from .durable import DurableRaftDir
            self._durable = DurableRaftDir(
                data_dir, policy_fn=self._fsync_policy,
                logger=lambda m: self.logger(m), scope=node_id)
        # restore telemetry (tests + the operator debug bundle): how the
        # last boot had to recover its on-disk state
        self.log_quarantined = False
        self.log_tail_truncated = 0
        self.log_migrated = False

        self._lock = threading.RLock()
        self._apply_cond = threading.Condition(self._lock)
        self._commit_cond = threading.Condition(self._lock)
        # Serializes every DurableRaftDir touch (ISSUE 20): the group
        # committer writes its batch OUTSIDE self._lock (so enqueuers
        # never block on an in-flight fsync), but meta persists, the
        # follower append path, compaction and snapshot installs all
        # write under self._lock — without this second lock a step-down
        # mid-batch could interleave two writers in one WAL file. Lock
        # ORDER: _lock -> _disk_lock, and never acquire _lock while
        # holding _disk_lock (the committer releases it before
        # re-entering _lock to publish).
        self._disk_lock = threading.Lock()
        # group-commit pipeline state (all guarded by self._lock): FIFO
        # of staged proposals + the single-committer flag. The committer
        # is the FIRST enqueuing caller; everything that queues while
        # its batch is appending/fsyncing lands in the NEXT batch —
        # self-clocking, no timer, no added latency floor.
        self._proposals: deque[_Proposal] = deque()
        self._committer_busy = False
        # wake-by-index commit waiters: (index, seq, proposal) min-heap;
        # the applier pops exactly the prefix the new last_applied
        # covers instead of broadcasting to every waiter (ISSUE 20
        # satellite — the thundering herd matters exactly when group
        # commit raises writer concurrency).
        self._commit_waiters: list = []
        self._waiter_seq = itertools.count()
        # True between a batch's durable append and its publish into
        # self.log: compaction must not regenerate the WAL inside that
        # window (the new generation is built from self.log, which does
        # not hold the in-flight frames yet — they would vanish from
        # disk the moment the batch publishes and acks)
        self._commit_in_flight = False

        # persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: list[_Entry] = []      # log[i] has index base_index + i + 1
        self.base_index = 0              # last index covered by the snapshot
        self.base_term = 0
        self.peers = dict(peers)         # id -> addr, includes self
        # autopilot non-voting members (raft-autopilot AddNonvoter): fully
        # replicated to, but excluded from elections and commit quorums
        # until promoted after stabilizing
        self.nonvoters: set[str] = set()
        # configuration as of base_index (snapshot point); the live config
        # is always _base_peers + the _config_* entries in the log, so a
        # truncated config entry can be rolled back (Raft §4.1: servers
        # adopt the latest configuration entry in their log at append time)
        self._base_peers = dict(peers)
        self._base_nonvoters: set[str] = set()

        # volatile state
        self.state = FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[str] = None
        self.leader_addr = ""
        self._last_contact = self.clock.monotonic()
        self._votes = 0
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._last_ok: dict[str, float] = {}   # peer -> last successful repl
        now = self.clock.monotonic()
        self._peer_added_at: dict[str, float] = {p: now for p in peers}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._replicate_events: dict[str, threading.Event] = {}
        # leadership observer (Server establish/revoke), called off-lock
        self.on_leadership_change: Callable[[bool], None] = lambda lead: None

        self._restore_from_disk()

        rpc_server.register("Raft.RequestVote", self._rpc_request_vote)
        rpc_server.register("Raft.AppendEntries", self._rpc_append_entries)
        rpc_server.register("Raft.InstallSnapshot", self._rpc_install_snapshot)

    # ------------------------------------------------------------ indexing

    def _last_index(self) -> int:
        return self.base_index + len(self.log)

    def _term_at(self, index: int) -> int:
        if index == self.base_index:
            return self.base_term
        if index < self.base_index or index > self._last_index():
            return -1
        return self.log[index - self.base_index - 1].term

    def _entry_at(self, index: int) -> _Entry:
        return self.log[index - self.base_index - 1]

    # --------------------------------------------------------- persistence

    def _fsync_policy(self) -> tuple:
        """-> (mode, interval_s) for the durable dir. Reads the raft-
        replicated SchedulerConfiguration each call — the same hot-
        reload path as every other runtime knob; NOMAD_RAFT_FSYNC
        (`mode` or `mode:interval_ms`) force-overrides for bench legs
        and tests."""
        env = os.environ.get("NOMAD_RAFT_FSYNC", "")
        if env:
            mode, _, iv = env.partition(":")
            if mode in ("always", "interval", "never"):
                try:
                    interval = float(iv) / 1000.0 if iv else 0.05
                except ValueError:
                    interval = 0.05
                return mode, interval
        try:
            cfg = self.fsm.state.get_scheduler_config()
            return cfg.raft_fsync, cfg.raft_fsync_interval_ms / 1000.0
        except Exception:       # noqa: BLE001 — config unreadable mid-
            return "always", 0.0    # restore: default to safety

    def _group_commit_max(self) -> int:
        """Group-commit window ceiling (ISSUE 20): how many queued
        proposals one committer drain may stage into a SINGLE WAL
        append + fsync. 1 = today's serial one-entry-per-sync shape
        (the differential-test oracle). Same hot-reload plumbing as
        _fsync_policy; NOMAD_RAFT_GROUP_COMMIT force-overrides for
        bench legs and the crash fuzzer."""
        env = os.environ.get("NOMAD_RAFT_GROUP_COMMIT", "")
        if env:
            try:
                return max(1, int(env))
            except ValueError:
                pass
        try:
            return max(1, int(self.fsm.state.get_scheduler_config()
                              .raft_group_commit_max_entries))
        except Exception:   # noqa: BLE001 — config unreadable mid-
            return 64           # restore: bounded default

    def _replicate_batch_max(self) -> int:
        """Per-AppendEntries shipping window (ISSUE 20): the follower
        persists the whole batch with ONE fsync before acking."""
        env = os.environ.get("NOMAD_RAFT_REPL_BATCH", "")
        if env:
            try:
                return max(1, int(env))
            except ValueError:
                pass
        try:
            return max(1, int(self.fsm.state.get_scheduler_config()
                              .raft_replicate_batch_max))
        except Exception:   # noqa: BLE001 — config unreadable mid-
            return 1024         # restore: bounded default

    def _persist_meta(self) -> None:
        if self._durable is None:
            return
        with self._disk_lock:
            # _disk_lock EXISTS to serialize durable I/O (the state
            # lock is not held here) — nomadlint: disable=LOCK003
            self._durable.save_meta(
                {"term": self.current_term, "voted_for": self.voted_for,
                 "peers": self.peers, "nonvoters": set(self.nonvoters)})

    def _append_to_disk(self, entries: list[_Entry]) -> None:
        """Append the TAIL `entries` (already in self.log) to the WAL."""
        if self._durable is None or not entries:
            return
        start = self._last_index() - len(entries) + 1
        with self._disk_lock:
            self._durable.append(
                start, [(e.term, e.type, e.payload) for e in entries])

    def _rewrite_log_on_disk(self) -> None:
        """After truncation/conflict resolution: commit a new log
        generation under the manifest (the snapshot is untouched)."""
        if self._durable is None:
            return
        with self._disk_lock:
            # truncation must be durable before any later append lands
            # behind it; _disk_lock is the I/O serialization lock, not
            # the state lock — nomadlint: disable=LOCK003
            self._durable.commit_generation(
                None, [(e.term, e.type, e.payload) for e in self.log],
                self.base_index + 1)

    def _snapshot_doc(self, data: bytes) -> dict:
        return {"index": self.base_index, "term": self.base_term,
                "data": data, "peers": dict(self._base_peers),
                "nonvoters": set(self._base_nonvoters)}

    def _restore_from_disk(self) -> None:
        if self._durable is None:
            return
        st = self._durable.load()
        self.log_quarantined = st.quarantined
        self.log_tail_truncated = st.tail_truncated_frames
        self.log_migrated = st.migrated
        if st.snapshot is not None:
            snap = st.snapshot
            self.fsm.restore_bytes(snap["data"])
            self.base_index = snap["index"]
            self.base_term = snap["term"]
            if snap.get("peers"):
                # authoritative config at snapshot time: replace, don't
                # merge — a merge would resurrect removed peers
                self.peers = dict(snap["peers"])
                self._base_peers = dict(snap["peers"])
                self.nonvoters = set(snap.get("nonvoters", ()))
                self._base_nonvoters = set(snap.get("nonvoters", ()))
            self.commit_index = self.last_applied = self.base_index
        if st.meta is not None:
            meta = st.meta
            self.current_term = meta["term"]
            self.voted_for = meta["voted_for"]
            if meta.get("peers"):
                self.peers = dict(meta["peers"])
                self.nonvoters = set(meta.get("nonvoters", ()))
        if st.entries:
            # frames are self-identifying: durable.load() already
            # verified contiguity from base_index+1, CRC-truncated any
            # torn tail, and quarantined mid-file damage — what arrives
            # here is replayable by construction
            for _idx, term, type_, payload in st.entries:
                self.log.append(_Entry(term, type_, payload))
            # Membership is adopted from the log at restore (config is
            # append-time state in this design), but the FSM is NOT:
            # a restarted server cannot know which tail entries were
            # committed — an ex-leader's log may end in UNCOMMITTED
            # entries a new leader will truncate and replace. Eagerly
            # applying them bakes phantom state into the FSM AND pins
            # last_applied past the replaced indexes, so the
            # replacements (including this node's own re-add/promote
            # config entries after an autopilot removal) are silently
            # skipped — the multi-process e2e rejoin test caught a
            # restarted server stuck as a permanent self-nonvoter this
            # way. Like hashicorp/raft: FSM = snapshot; log entries
            # re-apply through the applier once a leader of the next
            # term re-establishes commitment (its election no-op).
            for e in self.log:
                if e.type == "_config_remove":
                    with self._lock:
                        self._apply_config_locked(e.payload)
                elif e.type == "_config_add":
                    with self._lock:
                        self._apply_config_add_locked(e.payload)
            self.commit_index = self.last_applied = self.base_index
            if self._voters() in ([], [self.node_id]):
                # sole voter: every entry in its own log IS committed
                # (majority of one) — eager replay keeps single-server
                # restarts serving immediately, with none of the
                # uncommitted-tail hazard above
                for i, e in enumerate(self.log):
                    idx = self.base_index + i + 1
                    if e.type in ("_config_remove", "_config_add",
                                  "_noop"):
                        continue
                    try:
                        self.fsm.apply(idx, e.type, e.payload)
                    except Exception as ex:   # noqa: BLE001
                        # a bad entry must never brick restart/replay
                        self.logger(
                            f"raft: fsm replay failed at {idx}: {ex!r}")
                self.commit_index = self.last_applied = self._last_index()
        if self.base_index or self.log:
            self.logger(
                f"raft: {self.node_id} restored snapshot to index "
                f"{self.base_index}, log to index {self._last_index()} "
                f"(term {self.current_term}); uncommitted tail applies "
                f"once a leader re-establishes commitment")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._stop.clear()
        t = threading.Thread(target=self._run_elections, daemon=True,
                             name=f"raft-elect-{self.node_id}")
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._run_apply, daemon=True,
                             name=f"raft-apply-{self.node_id}")
        t.start()
        self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            self._commit_cond.notify_all()
            self._apply_cond.notify_all()
            for ev in self._replicate_events.values():
                ev.set()
            # release apply() waiters promptly: commit waiters break on
            # the stop flag once woken (same contract as the old
            # cond-broadcast shutdown)
            while self._commit_waiters:
                heapq.heappop(self._commit_waiters)[2].done.set()
        if self._durable is not None:
            with self._disk_lock:
                self._durable.close()

    # ------------------------------------------------------- public: apply

    def _voters(self) -> list[str]:
        return [pid for pid in self.peers if pid not in self.nonvoters]

    def fence_token(self) -> Optional[int]:
        """The leadership fence (ISSUE 6): the current term while this
        node is leader, else None. A caller that captured the token
        before a side-effect-free preparation phase (the plan applier's
        batch evaluation) passes it back to `apply(fence=...)` — the
        write is rejected ATOMICALLY, before the entry is appended, if
        leadership was lost (or lost and re-won at a higher term, i.e.
        state may have changed under an interim leader) in between.
        Contract: docs/FAILOVER.md."""
        with self._lock:
            return self.current_term if self.state == LEADER else None

    def apply(self, msg_type: str, payload, timeout: float = 30.0,
              fence: Optional[int] = None):
        """Commit one message through the replicated log. Leader-only;
        raises NotLeaderError with a redirect hint on followers.

        `timeout` is the caller's remaining budget for THIS message, not
        a per-message constant: the coalescing plan applier passes the
        remainder of its per-batch budget, so a batch of N plans riding
        one entry never waits N x 30s (docs/COMMIT_COALESCING.md). A
        timeout is counted (`nomad.raft.apply_timeout`) — the plan
        applier layers its per-plan `nomad.plan.commit_timeout` on top.

        `fence` (a fence_token() value) rejects the write atomically —
        FencedWriteError, entry NOT appended, commit provably impossible
        — when the term has moved since the token was captured.

        Group commit (ISSUE 20): callers ENQUEUE proposals; the first
        enqueuer becomes the committer and drains everything queued
        while the previous batch was appending/fsyncing into ONE
        multi-entry WAL append (one fsync at raft_fsync=always). Acks
        stay per-proposal: this caller returns only once ITS index is
        durable and applied, and a persist failure fails the whole
        batch with nothing entered into memory (the PR-13 memory==disk
        invariant at batch granularity, via disk-first staging)."""
        from .. import faults
        faults.fire("raft.apply")
        faults.fire(f"raft.apply.{self.node_id}")
        # idempotency stamp (ISSUE 18): a dedup-tokened RPC dispatch on
        # this thread marks the entry BEFORE append, so the ack
        # replicates with the write and survives failover (rpc/dedup.py)
        from ..rpc import dedup as rpc_dedup
        payload = rpc_dedup.stamp(payload)
        t_enter = time.monotonic()
        prop = _Proposal(msg_type, payload, fence)
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_addr)
            if fence is not None and fence != self.current_term:
                # deposed (and possibly re-elected at a higher term)
                # since the caller captured its token: the caller's
                # prepared write raced another leader's commits. Checked
                # under the SAME lock that serializes step-down, so the
                # rejection is atomic with the append decision (the
                # committer re-checks at staging time for proposals that
                # queue before a step-down lands).
                metrics.incr("nomad.raft.fence_rejected")
                from ..obs import trace
                trace.annotate(fence_rejected=True, fence_expected=fence,
                               fence_current=self.current_term)
                raise FencedWriteError(self.current_term, fence,
                                       self.leader_addr)
            self._proposals.append(prop)
            run_committer = not self._committer_busy
            if run_committer:
                self._committer_busy = True
        if run_committer:
            self._commit_proposals()
        deadline = t_enter + timeout
        index = 0
        while True:
            with self._lock:
                if prop.error is not None:
                    raise prop.error
                if prop.appended:
                    index = prop.index
                    if msg_type in _CONFIG_TYPES:
                        # membership changes take effect at append
                        # (adopted by the committer) and commit
                        # asynchronously once the NEW majority acks —
                        # blocking here would deadlock a 1→2 addition
                        # where the joining server only starts raft
                        # after `join` returns (hashicorp/raft AddVoter
                        # likewise returns an index future)
                        return index
                    if self.last_applied >= index or self._stop.is_set():
                        break
                    if self.state != LEADER:
                        # the entry IS appended; it may still commit
                        # under the next leader — callers must not
                        # retry/forward (ref hashicorp/raft
                        # ErrLeadershipLost)
                        raise LeadershipLostError(self.leader_addr)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    metrics.incr("nomad.raft.apply_timeout")
                    raise TimeoutError(
                        f"raft apply of {msg_type} timed out at index "
                        f"{prop.index} (budget {timeout:.1f}s)")
            # wait OUTSIDE the lock, in bounded slices: the wake is the
            # per-proposal event (set by the committer on failure or by
            # the applier exactly when this index is covered), and the
            # slices keep leadership loss / shutdown / timeout
            # observable even if no wake ever arrives
            prop.done.wait(min(remaining, 0.5))
        with self._lock:
            # leadership lost mid-wait: a new leader may have overwritten
            # our uncommitted entry at this index (hashicorp/raft returns
            # ErrLeadershipLost for exactly this)
            if index > self.base_index and \
                    self._term_at(index) != prop.term:
                raise LeadershipLostError(self.leader_addr)
        metrics.add_sample("nomad.raft.apply_wait",
                           time.monotonic() - t_enter)
        # attribute the replication wait + assigned index onto the
        # caller's in-flight span (the applier's plan.commit, ISSUE 7)
        from ..obs import trace
        trace.annotate(raft_index=index, term=prop.term,
                       replicate_wait_s=round(
                           time.monotonic() - t_enter, 6))
        return index

    def _commit_proposals(self) -> None:
        """THE group committer (ISSUE 20): runs on the first enqueuing
        caller's thread and drains the proposal queue batch by batch
        until it is empty, then clears the busy flag — so any queued
        proposal always has a live committer, and an idle leader's lone
        proposal commits immediately on its own thread (no timer, no
        handoff latency).

        Disk-first staging keeps memory == disk at batch granularity:
        staged entries enter self.log only AFTER the durable append
        succeeds, so the replicate loops can never ship an entry that a
        persist failure would roll back (same-index+term ⇒ same-entry
        stays inviolate), and a failed batch leaves memory untouched —
        every batch-mate fails, none half-lands. A batch orphaned on
        disk by a mid-write deposition resolves at the next append or
        boot through the WAL's index-regression later-write-wins rule
        (docs/DURABILITY.md)."""
        while True:
            with self._lock:
                if not self._proposals:
                    if (self.last_applied < self.commit_index
                            and not self._stop.is_set()):
                        # an apply window is in flight: park (bounded)
                        # instead of resigning the committer role. The
                        # waiters that apply wakes re-enqueue into ONE
                        # drain here, rather than racing a fresh
                        # committer one at a time — the thundering-herd
                        # shape that halves batch sizes under storm
                        # load. An idle leader never enters this arm
                        # (applier caught up ⇒ immediate exit), so the
                        # lone-proposal latency floor stays zero.
                        self._apply_cond.wait(0.05)
                        continue
                    self._committer_busy = False
                    return
                if self._stop.is_set():
                    while self._proposals:
                        p = self._proposals.popleft()
                        p.error = NotLeaderError(self.leader_addr)
                        p.done.set()
                    self._committer_busy = False
                    return
                limit = self._group_commit_max()
                batch = []
                while self._proposals and len(batch) < limit:
                    batch.append(self._proposals.popleft())
                if self.state != LEADER:
                    for p in batch:
                        p.error = NotLeaderError(self.leader_addr)
                        p.done.set()
                    continue
                term = self.current_term
                accepted = []
                for p in batch:
                    if p.fence is not None and p.fence != term:
                        # the term moved while this proposal sat queued:
                        # same atomic rejection as the enqueue-time
                        # check — the entry is provably not appended
                        metrics.incr("nomad.raft.fence_rejected")
                        p.error = FencedWriteError(term, p.fence,
                                                   self.leader_addr)
                        p.done.set()
                        continue
                    accepted.append(p)
                if not accepted:
                    continue
                start = self._last_index() + 1
                frames = []
                for off, p in enumerate(accepted):
                    p.term = term
                    p.index = start + off
                    frames.append((term, p.msg_type, p.payload))
                durable = self._durable
                self._commit_in_flight = True
                # take the disk lock BEFORE releasing the state lock
                # (consistent _lock -> _disk_lock order): from here to
                # release, no other durable writer can interleave with
                # this batch's frames
                self._disk_lock.acquire()
            persist_err: Optional[BaseException] = None
            try:
                if durable is not None:
                    try:
                        # one append per drained WINDOW, never per
                        # entry — this IS the amortized batch call:
                        # nomadlint: disable=DUR002 — per-window batch
                        durable.append(start, frames)
                    except Exception as e:   # noqa: BLE001
                        persist_err = e
            finally:
                self._disk_lock.release()
            if persist_err is None:
                try:
                    # crash window between the durable batch append and
                    # its acks (ISSUE 20 fuzzer site): treated exactly
                    # like a persist failure — nothing entered memory,
                    # the indexes will be re-staged, and the orphaned
                    # frames resolve by the index-regression rule
                    from .. import faults
                    faults.fire("raft.group_commit.ack")
                    faults.fire(f"raft.group_commit.ack.{self.node_id}")
                except Exception as e:   # noqa: BLE001
                    persist_err = e
            with self._lock:
                self._commit_in_flight = False
                if persist_err is not None:
                    # durability first: the WHOLE batch's callers see
                    # the failure and no entry is visible to
                    # replication or the FSM — memory and disk stay one
                    # object (any flushed prefix is superseded on the
                    # next append at the same indexes)
                    for p in accepted:
                        p.error = persist_err
                        p.done.set()
                    continue
                if self.state != LEADER or self.current_term != term:
                    # deposed while the batch was on its way to disk:
                    # disk-first staging means self.log never saw these
                    # entries, so there is nothing to roll back
                    for p in accepted:
                        p.error = LeadershipLostError(self.leader_addr)
                        p.done.set()
                    continue
                if self._last_index() + 1 != start:
                    # a leader-elect establishment batch landed between
                    # staging and publish (state flips to LEADER before
                    # _become_leader appends): the reserved indexes
                    # moved under us. Re-stage the same proposals at
                    # the head of the queue — the superseding append
                    # overwrites the orphaned frames.
                    for p in reversed(accepted):
                        self._proposals.appendleft(p)
                    continue
                for p in accepted:
                    e = _Entry(term, p.msg_type, p.payload)
                    self.log.append(e)
                    if p.msg_type in _CONFIG_TYPES:
                        # adopt the new configuration at append time
                        # (§4.1); a leader removing itself keeps
                        # replicating but no longer counts toward
                        # majority, and steps down only once the entry
                        # commits (§4.2.2, handled by the apply loop)
                        self._adopt_config_locked(e)
                        p.appended = True
                        p.done.set()   # config callers return at append
                    else:
                        p.appended = True
                        heapq.heappush(
                            self._commit_waiters,
                            (p.index, next(self._waiter_seq), p))
                self._match_index[self.node_id] = self._last_index()
                metrics.add_sample("nomad.raft.batch_entries",
                                   len(accepted))
                for ev in self._replicate_events.values():
                    ev.set()
                if len(self._voters()) == 1:
                    self._advance_commit_locked()

    def bootstrap_with(self, peers: dict[str, str]) -> bool:
        """One-shot cluster bootstrap with a full initial configuration
        (ref serf maybeBootstrap -> raft.BootstrapCluster): every server
        of a bootstrap_expect=N group calls this with the SAME sorted
        member set once gossip has found N servers, then elections run
        over that config. No-op unless this node is still pristine."""
        with self._lock:
            if self._last_index() > 0 or len(self.peers) > 1:
                return False            # already part of a cluster
            self.peers = dict(peers)
            self._base_peers = dict(peers)
            self.bootstrap = True
            self._persist_meta()
            return True

    def add_peer(self, peer_id: str, addr: str, timeout: float = 30.0,
                 voter: bool = True) -> int:
        """Single-entry membership addition (ref raft AddVoter /
        AddNonvoter): replicate a _config_add entry; the leader starts
        replicating to the new peer on apply. Non-voters receive the full
        log but stay out of quorums until promote_peer."""
        with self._lock:
            if peer_id in self.peers and self.peers[peer_id] == addr and \
                    (peer_id not in self.nonvoters) == voter:
                return self.last_applied
        return self.apply("_config_add", (peer_id, addr, voter),
                          timeout=timeout)

    def promote_peer(self, peer_id: str, timeout: float = 30.0) -> int:
        """Non-voter -> voter (raft-autopilot promotion after the server
        stabilization window)."""
        with self._lock:
            if peer_id not in self.nonvoters:
                return self.last_applied
            addr = self.peers.get(peer_id, "")
        return self.apply("_config_add", (peer_id, addr, True),
                          timeout=timeout)

    def remove_peer(self, peer_id: str, timeout: float = 30.0) -> int:
        """Single-entry membership change: replicate a _config_remove entry;
        every node drops the peer on apply (ref raft RemoveServer /
        operator raft remove-peer). Removing self steps down."""
        if peer_id not in self.peers:
            raise ValueError(f"unknown raft peer {peer_id!r}")
        if len(self.peers) <= 1:
            raise ValueError("cannot remove the last raft peer")
        return self.apply("_config_remove", peer_id, timeout=timeout)

    def _adopt_config_locked(self, entry: "_Entry") -> None:
        """Structural config change without the leader-self-removal
        step-down — safe to run at append time and idempotent at commit."""
        if entry.type == "_config_add":
            self._apply_config_add_locked(entry.payload)
            return
        pid = entry.payload
        self.peers.pop(pid, None)
        self.nonvoters.discard(pid)
        self._next_index.pop(pid, None)
        self._match_index.pop(pid, None)
        ev = self._replicate_events.pop(pid, None)
        if ev is not None:
            ev.set()    # wake the loop so it notices removal and exits
        self._peer_added_at.pop(pid, None)
        self._persist_meta()

    def _recompute_config_locked(self) -> None:
        """Rebuild the configuration from the snapshot-point config plus
        every _config_* entry still in the log. Called after log truncation
        on a follower: a conflicting leader may have removed an appended
        (never-committed) config entry, which must be rolled back."""
        peers = dict(self._base_peers)
        nonvoters = set(self._base_nonvoters)
        for e in self.log:
            if e.type == "_config_add":
                pid, addr, voter = e.payload if len(e.payload) == 3 \
                    else (*e.payload, True)
                peers[pid] = addr
                if voter:
                    nonvoters.discard(pid)
                else:
                    nonvoters.add(pid)
            elif e.type == "_config_remove":
                peers.pop(e.payload, None)
                nonvoters.discard(e.payload)
        if peers != self.peers or nonvoters != self.nonvoters:
            self.peers = peers
            self.nonvoters = nonvoters
            self._persist_meta()

    def _apply_config_locked(self, payload) -> None:
        pid = payload
        self._adopt_config_locked(_Entry(0, "_config_remove", pid))
        if pid == self.node_id and self.state == LEADER:
            self._step_down_locked(self.current_term)

    def _apply_config_add_locked(self, payload) -> None:
        pid, addr, voter = payload if len(payload) == 3 else (*payload, True)
        if pid in self.peers:
            self.peers[pid] = addr
            if voter:
                self.nonvoters.discard(pid)
            else:
                self.nonvoters.add(pid)
            self._persist_meta()
            return
        self.peers[pid] = addr
        if not voter:
            self.nonvoters.add(pid)
        self._peer_added_at[pid] = self.clock.monotonic()
        self._persist_meta()
        if self.state == LEADER:
            self._next_index[pid] = self._last_index() + 1
            self._match_index[pid] = 0
            ev = threading.Event()
            self._replicate_events[pid] = ev
            t = threading.Thread(target=self._replicate_loop, daemon=True,
                                 args=(pid, self.current_term),
                                 name=f"raft-repl-{pid}")
            t.start()
            self._threads.append(t)
            ev.set()

    def server_health(self) -> list[dict]:
        """Per-peer replication health (operator autopilot health analog)."""
        with self._lock:
            now = self.clock.monotonic()
            is_leader = self.state == LEADER
            out = []
            for pid, addr in sorted(self.peers.items()):
                known_for = now - self._peer_added_at.get(pid, now)
                if pid == self.node_id:
                    healthy, age = True, 0.0
                elif is_leader:
                    last = self._last_ok.get(pid)
                    age = (now - last) if last is not None else float("inf")
                    healthy = age < max(1.0, self.heartbeat_interval * 10)
                elif pid == self.leader_id:
                    # a follower knows only its leader's liveness
                    age = now - self._last_contact
                    healthy = age < max(1.0, self.election_timeout[0])
                else:
                    # unknown from here: only the leader tracks replication
                    age, healthy = None, None
                out.append({
                    "ID": pid, "Address": addr,
                    "Leader": pid == self.node_id and is_leader
                    or pid == self.leader_id,
                    "Voter": pid not in self.nonvoters,
                    "Healthy": healthy,
                    "LastContactSec": None
                    if age in (None, float("inf")) else age,
                    "KnownForSec": known_for,
                    "MatchIndex": self._match_index.get(pid, 0)
                    if is_leader else None,
                })
            return out

    def barrier(self) -> int:
        with self._lock:
            return self.last_applied

    def wait_barrier(self, timeout: float = 30.0) -> int:
        """Block until every entry in the log as of THIS call is applied
        to the FSM (ref hashicorp/raft Barrier, used by leader.go:224
        establishLeadership). A new leader's log already ends with its
        election no-op (§8), so waiting for the current last index
        guarantees all entries committed under previous terms are
        visible in state before the leader restores broker/watcher
        bookkeeping from it — without this, a freshly-elected leader can
        re-enqueue an eval whose plan it has not applied yet and place
        DUPLICATE allocations (caught by the multi-process e2e tier)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            target = self._last_index()
            while self.last_applied < target and not self._stop.is_set():
                if self.state != LEADER:
                    raise NotLeaderError(self.leader_addr)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"leadership barrier timed out at {target}")
                self._apply_cond.wait(min(remaining, 0.5))
            return self.last_applied

    def snapshot(self) -> bytes:
        return self.fsm.snapshot_bytes()

    def restore(self, data: bytes) -> None:
        """Operator-initiated restore (snapshot_restore endpoint)."""
        self.fsm.restore_bytes(data)

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def quorum_fresh(self, window: Optional[float] = None) -> bool:
        """Leader-lease check (read-index lite, ISSUE 18): True iff this
        node is leader AND has replicated successfully to a voting
        quorum within `window` seconds (default: half the minimum
        election timeout — no rival can have been elected while a
        quorum was heard from inside that window). A leader that heals
        from a partition still believing it leads fails this check
        until its next successful replication round, so local-state
        fast paths (e.g. the unchanged-status heartbeat ack) must not
        vouch for reads taken from a possibly-deposed leader's state —
        acking a write from stale state LOSES it (docs/PARTITIONS.md)."""
        with self._lock:
            if self.state != LEADER:
                return False
            voters = [pid for pid in self.peers
                      if pid not in self.nonvoters]
            need = len(voters) // 2 + 1
            if need <= 1:
                return True
            w = window if window is not None \
                else self.election_timeout[0] / 2.0
            now = self.clock.monotonic()
            fresh = sum(
                1 for pid in voters
                if pid == self.node_id
                or now - self._last_ok.get(pid, float("-inf")) <= w)
            return fresh >= need

    def leadership(self) -> tuple[bool, str]:
        with self._lock:
            if self.state == CANDIDATE:
                # mid-election there is NO known leader: advertising the
                # deposed one would forward RPCs at a server we just
                # timed out on, and stale reads must be able to stamp
                # KnownLeader=False while a vote is in flight (ISSUE 16)
                return False, ""
            return self.state == LEADER, self.leader_addr

    # ----------------------------------------------------------- elections

    def _election_deadline(self) -> float:
        lo, hi = self.election_timeout
        return self.clock.monotonic() + self._rng.uniform(lo, hi)

    def _run_elections(self) -> None:
        deadline = self._election_deadline()
        while not self._stop.is_set():
            # REAL poll cadence by design: under a ManualClock the loop
            # keeps spinning but deadlines only expire when the test
            # advances virtual time (chrono.py)
            time.sleep(0.02)
            with self._lock:
                if self.state == LEADER:
                    deadline = self._election_deadline()
                    continue
                if self.clock.monotonic() < deadline:
                    continue
                # recent leader contact pushes the deadline instead of
                # triggering an election
                lo, _hi = self.election_timeout
                if self.clock.monotonic() - self._last_contact < lo:
                    deadline = self._last_contact + \
                        self._rng.uniform(*self.election_timeout)
                    continue
                # a non-bootstrap server with only itself in config is
                # waiting for adoption, not for votes; a non-voter never
                # campaigns at all (raft-autopilot nonvoter semantics)
                if not self.bootstrap and len(self.peers) <= 1:
                    deadline = self._election_deadline()
                    continue
                if self.node_id in self.nonvoters:
                    deadline = self._election_deadline()
                    continue
                prev_term, prev_vote = self.current_term, self.voted_for
                self.current_term += 1
                self.voted_for = self.node_id
                try:
                    self._persist_meta()
                except Exception as e:   # noqa: BLE001
                    # an unpersisted self-vote must never be acted on: a
                    # crash would forget it and this term could see a
                    # second vote — revert to the PRIOR persisted pair
                    # (never to None: that would erase the memory of a
                    # vote already granted in prev_term and allow a
                    # second grant there) and retry next deadline
                    self.current_term = prev_term
                    self.voted_for = prev_vote
                    self.logger(f"raft: vote persist failed, campaign "
                                f"aborted: {e!r}")
                    deadline = self._election_deadline()
                    continue
                self.state = CANDIDATE
                self._votes = 1
                term = self.current_term
                self.logger(f"raft: {self.node_id} campaigning "
                            f"(term {term})")
                last_idx = self._last_index()
                last_term = self._term_at(last_idx)
                peers = {pid: addr for pid, addr in self.peers.items()
                         if pid != self.node_id and
                         pid not in self.nonvoters}
                deadline = self._election_deadline()
            if not peers:
                self._become_leader(term)
                continue
            for pid, addr in peers.items():
                threading.Thread(
                    target=self._request_vote_from, daemon=True,
                    args=(pid, addr, term, last_idx, last_term)).start()

    def _request_vote_from(self, pid, addr, term, last_idx, last_term):
        try:
            with self.rpc_server.client_for(addr, timeout=1.0) as cli:
                resp = cli.call("Raft.RequestVote", term, self.node_id,
                                last_idx, last_term)
        except Exception:    # noqa: BLE001
            return
        with self._lock:
            if resp["term"] > self.current_term:
                self._step_down_locked(resp["term"])
                return
            if self.state != CANDIDATE or term != self.current_term:
                return
            if resp["granted"]:
                self._votes += 1
                if self._votes * 2 > len(self._voters()):
                    # transition exactly once: later vote responses see
                    # state != CANDIDATE and bail above
                    self.state = LEADER
                    threading.Thread(target=self._become_leader, daemon=True,
                                     args=(term,)).start()

    def _become_leader(self, term: int) -> None:
        with self._lock:
            if self.current_term != term:
                return
            self.state = LEADER     # idempotent for the self-elect path
            self.leader_id = self.node_id
            self.leader_addr = self.addr
            nxt = self._last_index() + 1
            self._next_index = {pid: nxt for pid in self.peers}
            self._match_index = {pid: 0 for pid in self.peers}
            self._match_index[self.node_id] = self._last_index()
            # baseline contact at election: a fresh leader must not report
            # never-contacted-yet peers as long-dead (autopilot would reap
            # a briefly-slow follower right after failover)
            now = self.clock.monotonic()
            self._last_ok = {pid: now for pid in self.peers}
            # commit a no-op entry to finalize commitment of prior terms
            # (Raft §8: a leader may only count replicas of current-term
            # entries toward commit)
            noop = _Entry(term, "_noop", {})
            # make membership fully log-described: re-append the current
            # config so servers adopted later (gossip auto-join with a
            # trivial {self} base config) learn EVERY member — including
            # those only present in this leader's bootstrap config —
            # purely from the log. Idempotent at adopt/apply time.
            cfg_entries = [_Entry(term, "_config_add",
                                  (pid, addr, pid not in self.nonvoters))
                           for pid, addr in self.peers.items()]
            establish = [noop] + cfg_entries
            self.log.extend(establish)
            try:
                self._append_to_disk(establish)
            except Exception as e:   # noqa: BLE001
                # a leader that cannot write its own log cannot lead:
                # roll the entries back and step down — the next
                # election re-tries (possibly on healed disk)
                del self.log[-len(establish):]
                self.logger(f"raft: establishment append failed, "
                            f"stepping down: {e!r}")
                self._step_down_locked(self.current_term)
                return
            self._match_index[self.node_id] = self._last_index()
            peers = {pid: addr for pid, addr in self.peers.items()
                     if pid != self.node_id}
            if len(self._voters()) == 1:
                # sole voter: its own match IS the quorum — non-voter
                # peers must not gate commitment of the term's entries
                self._advance_commit_locked()
        self.logger(f"raft: {self.node_id} became leader (term {term})")
        for pid in peers:
            ev = threading.Event()
            ev.set()
            self._replicate_events[pid] = ev
            t = threading.Thread(target=self._replicate_loop, daemon=True,
                                 args=(pid, term), name=f"raft-repl-{pid}")
            t.start()
            self._threads.append(t)
        self.on_leadership_change(True)

    def _step_down_locked(self, term: int) -> None:
        was_leader = self.state == LEADER
        if term > self.current_term:
            # only a term bump may reset the vote (one vote per term)
            self.current_term = term
            self.voted_for = None
        self.state = FOLLOWER
        try:
            self._persist_meta()
        except Exception as e:   # noqa: BLE001
            # stepping down must never fail: callers include the
            # election/replication threads (an escaped exception kills
            # the daemon for good) and the establishment-failure path
            # (which would leave leader_id advertising a follower).
            # Vote safety is unaffected — any future grant/campaign
            # re-persists term+vote atomically BEFORE acting, and is
            # itself withheld when that persist fails
            self.logger(f"raft: meta persist failed during step-down "
                        f"(continuing as follower): {e!r}")
        if was_leader:
            self.leader_id = None
            self.leader_addr = ""
            threading.Thread(target=self.on_leadership_change, daemon=True,
                             args=(False,)).start()

    # --------------------------------------------------------- replication

    def _replicate_loop(self, pid: str, term: int) -> None:
        addr = self.peers.get(pid)
        if addr is None:
            return
        cli = self.rpc_server.client_for(addr, timeout=2.0)
        ev = self._replicate_events[pid]
        fails = 0
        try:
            while not self._stop.is_set():
                with self._lock:
                    if self.state != LEADER or self.current_term != term:
                        return
                    if pid not in self.peers:
                        return   # removed from the config mid-term
                ev.wait(self.heartbeat_interval)
                ev.clear()
                try:
                    self._replicate_once(cli, pid, term)
                    if fails >= 10:
                        self.logger(f"raft: replication to {pid} "
                                    f"recovered")
                    fails = 0
                except Exception as e:   # noqa: BLE001
                    fails += 1
                    if fails in (10, 100, 1000):   # once per decade, not
                        self.logger(           # one line per heartbeat
                            f"raft: replication to {pid} ({addr}) "
                            f"failing x{fails}: {e!r}")
                    time.sleep(self.heartbeat_interval)
        finally:
            cli.close()

    def _replicate_once(self, cli, pid: str, term: int) -> None:
        with self._lock:
            if self.state != LEADER or self.current_term != term \
                    or pid not in self.peers:
                return
            nxt = self._next_index.get(pid, self._last_index() + 1)
            if nxt <= self.base_index:
                # follower is behind our snapshot horizon
                # ship the config as of base_index, not the live one: the
                # receiver stores this as its rollback base, and live peers
                # may include uncommitted config entries past base_index
                snap = {"index": self.base_index, "term": self.base_term,
                        "data": self.fsm.snapshot_bytes(),
                        "peers": dict(self._base_peers),
                        "nonvoters": sorted(self._base_nonvoters)}
                commit = self.commit_index
            else:
                snap = None
                prev_idx = nxt - 1
                prev_term = self._term_at(prev_idx)
                # ship the full pending window, bounded by the hot-
                # reloadable replication knob (ISSUE 20): the follower
                # persists the whole batch with ONE fsync before acking
                win = self._replicate_batch_max()
                entries = [(e.term, e.type, e.payload)
                           for e in self.log[prev_idx - self.base_index:
                                             prev_idx - self.base_index
                                             + win]]
                if entries:
                    metrics.add_sample("nomad.raft.replicate_batch_entries",
                                       len(entries))
                commit = self.commit_index
        if snap is not None:
            resp = cli.call("Raft.InstallSnapshot", term, self.node_id,
                            self.addr, snap)
            with self._lock:
                if resp["term"] > self.current_term:
                    self._step_down_locked(resp["term"])
                    return
                self._next_index[pid] = snap["index"] + 1
                self._match_index[pid] = snap["index"]
                self._last_ok[pid] = self.clock.monotonic()
            return
        resp = cli.call("Raft.AppendEntries", term, self.node_id, self.addr,
                        prev_idx, prev_term, entries, commit)
        with self._lock:
            if resp["term"] > self.current_term:
                self._step_down_locked(resp["term"])
                return
            if self.state != LEADER or self.current_term != term:
                return
            if resp["success"]:
                match = prev_idx + len(entries)
                self._last_ok[pid] = self.clock.monotonic()
                self._match_index[pid] = max(self._match_index.get(pid, 0),
                                             match)
                self._next_index[pid] = self._match_index[pid] + 1
                self._advance_commit_locked()
                if self._next_index[pid] <= self._last_index():
                    ev = self._replicate_events.get(pid)
                    if ev is not None:
                        ev.set()   # more to send
            elif resp.get("retry"):
                # follower persist hiccup, not a conflict: keep
                # next_index where it is; the loop's heartbeat-interval
                # wait retries the identical batch until the disk heals
                pass
            else:
                # conflict: back up (follower hints its last index)
                hint = resp.get("last_index")
                self._next_index[pid] = max(
                    1, min(nxt - 1, (hint + 1) if hint is not None else nxt - 1))
                ev = self._replicate_events.get(pid)
                if ev is not None:
                    ev.set()

    def _advance_commit_locked(self) -> None:
        """Majority-match commit rule over VOTERS (current-term entries
        only; non-voters replicate but never count, raft §4.2.1)."""
        matches = sorted(self._match_index.get(pid, 0)
                         for pid in self._voters())
        majority_idx = matches[(len(matches) - 1) // 2]
        if majority_idx > self.commit_index and \
                self._term_at(majority_idx) == self.current_term:
            self.commit_index = majority_idx
            self._commit_cond.notify_all()

    # --------------------------------------------------------------- apply

    def _wake_applied_locked(self) -> None:
        """Wake exactly the apply() waiters whose index the new
        last_applied covers (wake-by-index, ISSUE 20 satellite): pop
        the covered prefix of the waiter heap instead of broadcasting
        to every writer parked on the node."""
        waiters = self._commit_waiters
        while waiters and waiters[0][0] <= self.last_applied:
            heapq.heappop(waiters)[2].done.set()

    def _run_apply(self) -> None:
        """Dedicated applier: keeps FSM application strictly ordered.
        When the commit index jumps N entries (group commit, batched
        replication), contiguous runs of FSM entries apply as ONE
        fsm.apply_batch window — one store-lock hold, one snapshot-memo
        displacement, one event-broker publish batch — and commit
        waiters wake once, by index (ISSUE 20)."""
        while not self._stop.is_set():
            with self._lock:
                while self.last_applied >= self.commit_index and \
                        not self._stop.is_set():
                    self._commit_cond.wait(0.5)
                if self._stop.is_set():
                    return
                start = self.last_applied + 1
                end = self.commit_index
                batch = [(i, self._entry_at(i)) for i in range(start, end + 1)]

            def _on_entry_error(idx: int, ex: BaseException) -> None:
                # per-entry error isolation inside a batched window: a
                # malformed entry must not drop its batch-mates
                self.logger(f"raft: fsm apply failed at {idx}: {ex!r}")

            i, n = 0, len(batch)
            while i < n:
                idx, e = batch[i]
                if e.type in _CONFIG_TYPES:
                    try:
                        with self._lock:
                            if e.type == "_config_remove":
                                self._apply_config_locked(e.payload)
                            else:
                                self._apply_config_add_locked(e.payload)
                    except Exception as ex:   # noqa: BLE001
                        # a meta-persist failure inside a config apply
                        # must not kill the applier: the config is
                        # adopted in memory and the LOG is the
                        # authority at restore — the meta peers field
                        # is a cache rebuilt from snapshot + log
                        self.logger(f"raft: config apply persist "
                                    f"failed at {idx}: {ex!r}")
                    i += 1
                elif e.type == "_noop":
                    i += 1
                else:
                    # contiguous FSM run: config/noop entries break the
                    # window so raft-state and store-state mutations
                    # stay in strict log order relative to each other
                    run = []
                    while i < n and batch[i][1].type not in _CONFIG_TYPES \
                            and batch[i][1].type != "_noop":
                        run.append((batch[i][0], batch[i][1].type,
                                    batch[i][1].payload))
                        i += 1
                    try:
                        self.fsm.apply_batch(run, on_error=_on_entry_error)
                    except Exception as ex:   # noqa: BLE001
                        self.logger(f"raft: fsm apply batch failed at "
                                    f"{run[0][0]}..{run[-1][0]}: {ex!r}")
            with self._lock:
                self.last_applied = end
                self._wake_applied_locked()
                self._apply_cond.notify_all()
                if len(self.log) >= self.snapshot_threshold:
                    try:
                        # compaction must be atomic with log state;
                        # audited ISSUE 13 — nomadlint: disable=LOCK003
                        self._compact_locked()
                    except Exception as ex:   # noqa: BLE001
                        # a failed compaction must not kill the applier:
                        # the manifest still names the old consistent
                        # generation, memory is already compacted, and
                        # the next apply batch retries
                        self.logger(
                            f"raft: compaction persist failed "
                            f"(retrying next batch): {ex!r}")

    def _compact_locked(self) -> None:
        """Snapshot the FSM and truncate the applied prefix of the log."""
        snap_index = self.last_applied
        if snap_index <= self.base_index:
            return
        if self._commit_in_flight:
            # a group-commit batch sits between its durable append and
            # its publish (ISSUE 20): the regenerated WAL would be
            # built from a self.log that lacks the in-flight frames,
            # silently un-persisting entries about to be acked. Skip;
            # the applier retries after the next batch.
            return
        data = self.fsm.snapshot_bytes()
        keep_from = snap_index - self.base_index
        self.base_term = self._term_at(snap_index)
        # fold config entries covered by the snapshot into the base config
        for e in self.log[:keep_from]:
            if e.type == "_config_add":
                pid, addr, voter = e.payload if len(e.payload) == 3 \
                    else (*e.payload, True)
                self._base_peers[pid] = addr
                if voter:
                    self._base_nonvoters.discard(pid)
                else:
                    self._base_nonvoters.add(pid)
            elif e.type == "_config_remove":
                self._base_peers.pop(e.payload, None)
                self._base_nonvoters.discard(e.payload)
        self.log = self.log[keep_from:]
        self.base_index = snap_index
        if self._durable is not None:
            # ONE generation commit (snapshot + truncated log behind an
            # atomic manifest replace) — the old persist-snapshot-then-
            # rewrite-log pair left a crash window in which an
            # index-less stale log shadowed the new snapshot (ISSUE 13)
            # raft persists before acking; the disk commit IS the state
            # transition, by design — nomadlint: disable=LOCK003
            with self._disk_lock:
                # same audit: _disk_lock is the durable-I/O serializer
                # (ISSUE 13/20) — nomadlint: disable=LOCK003
                self._durable.commit_generation(
                    self._snapshot_doc(data),
                    [(e.term, e.type, e.payload) for e in self.log],
                    self.base_index + 1)

    # ------------------------------------------------------- RPC handlers

    def _rpc_request_vote(self, term, candidate_id, last_idx, last_term):
        with self._lock:
            if self._stop.is_set():
                return {"term": self.current_term, "granted": False}
            if term > self.current_term:
                self._step_down_locked(term)
            granted = False
            if term == self.current_term and \
                    self.voted_for in (None, candidate_id):
                my_last = self._last_index()
                my_term = self._term_at(my_last)
                up_to_date = (last_term, last_idx) >= (my_term, my_last)
                if up_to_date:
                    granted = True
                    prev_vote = self.voted_for
                    self.voted_for = candidate_id
                    try:
                        # the vote must be durable BEFORE the grant
                        # leaves this server (fsync=always): a granted-
                        # then-forgotten vote is the double-vote hole
                        self._persist_meta()
                    except Exception as e:   # noqa: BLE001
                        # revert to the PRIOR value (a retransmitted
                        # grant's prev is the same candidate — setting
                        # None instead would forget the original
                        # persisted grant and free this term's vote)
                        self.voted_for = prev_vote
                        granted = False
                        self.logger(f"raft: vote persist failed, grant "
                                    f"withheld: {e!r}")
                        return {"term": self.current_term,
                                "granted": False}
                    self._last_contact = self.clock.monotonic()
                    # the old leader is presumed dead: stop advertising it
                    # for forwarding until the new leader heartbeats us
                    self.leader_id = None
                    self.leader_addr = ""
            return {"term": self.current_term, "granted": granted}

    def _rpc_append_entries(self, term, leader_id, leader_addr,
                            prev_idx, prev_term, entries, leader_commit):
        with self._lock:
            if self._stop.is_set():
                # a shut-down node must not ack replication: live pooled
                # connections would otherwise keep it looking healthy
                return {"term": self.current_term, "success": False}
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._step_down_locked(term)
            self.leader_id = leader_id
            self.leader_addr = leader_addr
            self._last_contact = self.clock.monotonic()

            if prev_idx > self._last_index() or \
                    (prev_idx >= self.base_index and
                     self._term_at(prev_idx) != prev_term):
                return {"term": self.current_term, "success": False,
                        "last_index": min(self._last_index(), prev_idx - 1)}
            if prev_idx < self.base_index:
                # snapshot already covers part of this batch
                skip = self.base_index - prev_idx
                entries = entries[skip:]
                prev_idx = self.base_index
            # append, truncating conflicts; the common case is a pure
            # append which hits the cheap append-only disk path.
            # truncation REBINDS self.log (slice copy), so orig_log
            # stays the untouched pre-RPC list — the persist-failure
            # path below restores it wholesale, keeping memory == disk
            orig_log = self.log
            truncated = False
            appended: list[_Entry] = []
            for i, (eterm, etype, epayload) in enumerate(entries):
                idx = prev_idx + i + 1
                if idx <= self._last_index():
                    if self._term_at(idx) != eterm:
                        self.log = self.log[:idx - self.base_index - 1]
                        truncated = True
                    else:
                        continue
                e = _Entry(eterm, etype, epayload)
                self.log.append(e)
                appended.append(e)
            persist_ok = True
            try:
                if truncated:
                    # replication ack only after the truncated log is
                    # durable (raft safety) — nomadlint: disable=LOCK003
                    self._rewrite_log_on_disk()
                elif appended:
                    self._append_to_disk(appended)
            except Exception as e:   # noqa: BLE001
                persist_ok = False
                self.logger(f"raft: follower persist failed: {e!r}")
                if truncated:
                    # a failed conflict rewrite must not leave memory
                    # truncated while disk still holds the old tail: a
                    # leader RETRY would then match memory and ack
                    # entries that never reached disk. Restore the
                    # pre-RPC log; the retry re-runs the whole exchange
                    self.log = orig_log
                    truncated = False
                elif appended:
                    # pure-append failure: roll the tail back so memory
                    # and disk agree, and make the leader retry
                    del self.log[-len(appended):]
                appended = []
            if truncated or any(e.type in _CONFIG_TYPES for e in appended):
                # adopt appended config entries immediately (§4.1) and roll
                # back any truncated ones, in one recompute
                self._recompute_config_locked()
            if appended:
                # crash window between a durable follower persist and
                # the ack leaving this server (ISSUE 20 fuzzer site): a
                # raise here drops the response — the leader retries
                # the identical batch, which matches in place and acks,
                # so a durably-persisted-but-unacked follower batch is
                # never double-applied and never lost
                from .. import faults
                faults.fire("raft.follower.ack")
                faults.fire(f"raft.follower.ack.{self.node_id}")
            if not persist_ok:
                # `retry` distinguishes a LOCAL persist hiccup from a
                # log conflict: the logs match, so the leader must not
                # walk next_index backwards (that re-ships ever-larger
                # matching prefixes and eventually a pointless
                # InstallSnapshot) — it just retries the same batch
                return {"term": self.current_term, "success": False,
                        "retry": True,
                        "last_index": self._last_index()}
            if leader_commit > self.commit_index:
                self.commit_index = min(leader_commit, self._last_index())
                self._commit_cond.notify_all()
            return {"term": self.current_term, "success": True}

    def _rpc_install_snapshot(self, term, leader_id, leader_addr, snap):
        with self._lock:
            if term < self.current_term:
                return {"term": self.current_term}
            if term > self.current_term or self.state != FOLLOWER:
                self._step_down_locked(term)
            self.leader_id = leader_id
            self.leader_addr = leader_addr
            self._last_contact = self.clock.monotonic()
            if snap["index"] <= self.base_index:
                return {"term": self.current_term}
            if self._durable is not None:
                # one atomic generation commit (snapshot + empty log +
                # manifest): the pre-WAL code wrote snapshot and log as
                # two files and a crash in between re-based the stale
                # log under the new snapshot. Persist BEFORE mutating
                # memory: if this raises, the handler surfaces the
                # error with memory untouched, so the leader's RETRY
                # is not short-circuited by an already-advanced
                # base_index into never persisting (which would strand
                # the durable dir's append cursor behind memory and
                # fail every subsequent replication append)
                peers = dict(snap["peers"]) if snap.get("peers") \
                    else dict(self._base_peers)
                nonvoters = set(snap.get("nonvoters", ())) \
                    if snap.get("peers") else set(self._base_nonvoters)
                # an installed snapshot must be durable before the node
                # acks it (raft safety) — nomadlint: disable=LOCK003
                with self._disk_lock:
                    # same audit: _disk_lock is the durable-I/O
                    # serializer — nomadlint: disable=LOCK003
                    self._durable.commit_generation(
                        {"index": snap["index"], "term": snap["term"],
                         "data": snap["data"], "peers": peers,
                         "nonvoters": nonvoters},
                        [], snap["index"] + 1)
            self.fsm.restore_bytes(snap["data"])
            self.base_index = snap["index"]
            self.base_term = snap["term"]
            self.log = []
            if snap.get("peers"):
                self.peers = dict(snap["peers"])
                self._base_peers = dict(snap["peers"])
                self.nonvoters = set(snap.get("nonvoters", ()))
                self._base_nonvoters = set(snap.get("nonvoters", ()))
            self.commit_index = max(self.commit_index, snap["index"])
            self.last_applied = snap["index"]
            self._persist_meta()
            return {"term": self.current_term}
