"""Previous-allocation watcher + ephemeral disk migration (ref
client/allocwatcher/alloc_watcher.go: NewAllocWatcher, localPrevAlloc,
remotePrevAlloc).

When a replacement alloc lands with `previous_allocation` set and its task
group asks for sticky/migrated ephemeral disk, the runner blocks until the
previous alloc is terminal, then moves (local) or downloads (remote, over
the previous node's HTTP fs API) each task's `local/` dir and the alloc
`data/` dir into the new alloc dir.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import urllib.parse
import urllib.request
from typing import Optional


class PrevAllocWatcher:
    """ref allocwatcher.NewAllocWatcher — picks local vs remote strategy."""

    def __init__(self, client, alloc, logger=None):
        self.client = client
        self.alloc = alloc
        self.logger = logger or (lambda msg: None)
        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job \
            else None
        disk = tg.ephemeral_disk if tg else None
        self.migrate = bool(disk and disk.migrate)
        self.sticky = bool(disk and (disk.sticky or disk.migrate))

    def wait_and_migrate(self, timeout: float = 300.0) -> bool:
        """Block until the previous alloc terminates, then migrate its data.
        Returns True if data was migrated."""
        prev_id = self.alloc.previous_allocation
        if not prev_id or not self.sticky:
            return False
        prev_runner = self.client.alloc_runners.get(prev_id)
        if prev_runner is not None:
            return self._local(prev_runner, timeout)
        # runner already reaped (the server stops advertising terminal
        # allocs) but the alloc dir may still be on this node's disk —
        # migrate straight from it
        prev_dir = os.path.join(self.client.alloc_dir_root, prev_id)
        if os.path.isdir(prev_dir):
            return self._move_dirs(prev_dir)
        if self.migrate:
            return self._remote(prev_id, timeout)
        return False

    # ---------------------------------------------------------------- local

    def _local(self, prev_runner, timeout: float) -> bool:
        """ref allocwatcher localPrevAlloc: same node — wait + move dirs."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if prev_runner.is_done() or prev_runner.alloc.terminal_status():
                break
            time.sleep(0.1)
        else:
            self.logger(f"allocwatcher: timed out waiting on {prev_runner.alloc.id}")
            return False
        return self._move_dirs(prev_runner.alloc_dir)

    def _move_dirs(self, src_root: str) -> bool:
        dst_root = os.path.join(self.client.alloc_dir_root, self.alloc.id)
        moved = False
        for rel in self._migratable_dirs():
            src = os.path.join(src_root, rel)
            if not os.path.isdir(src):
                continue
            dst = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.rmtree(dst, ignore_errors=True)
            shutil.move(src, dst)
            moved = True
        return moved

    # --------------------------------------------------------------- remote

    def _remote(self, prev_id: str, timeout: float) -> bool:
        """ref allocwatcher remotePrevAlloc: previous alloc ran on another
        node — poll the servers for its terminal state, then walk the old
        node's /v1/client/fs API and download."""
        deadline = time.time() + timeout
        prev = node_addr = None
        while time.time() < deadline:
            try:
                prev = self.client.rpc.alloc_get(prev_id)
            except Exception:       # noqa: BLE001 — server may be slow
                prev = None
            if prev is not None and prev.terminal_status():
                break
            time.sleep(0.5)
        if prev is None or not prev.terminal_status():
            # never migrate from a still-running alloc (torn reads)
            self.logger(f"allocwatcher: prev {prev_id[:8]} not terminal")
            return False
        node_addr = self._node_http_addr(prev.node_id)
        if not node_addr:
            self.logger(f"allocwatcher: no HTTP addr for node {prev.node_id}")
            return False
        dst_root = os.path.join(self.client.alloc_dir_root, self.alloc.id)
        moved = False
        for rel in self._migratable_dirs():
            if self._download_tree(node_addr, prev_id, rel, dst_root):
                moved = True
        return moved

    def _node_http_addr(self, node_id: str) -> str:
        getter = getattr(self.client.rpc, "node_get_http_addr", None)
        if getter is not None:
            try:
                return getter(node_id) or ""
            except Exception:       # noqa: BLE001
                return ""
        return ""

    def _download_tree(self, base: str, alloc_id: str, rel: str,
                       dst_root: str) -> bool:
        """Recursively fetch one directory via /v1/client/fs/{ls,cat}."""
        try:
            entries = self._http_json(
                base, f"/v1/client/fs/ls/{alloc_id}?path="
                + urllib.parse.quote(rel))
        except OSError:
            return False
        got = False
        for e in entries:
            sub = f"{rel}/{e['Name']}"
            if e.get("IsDir"):
                if self._download_tree(base, alloc_id, sub, dst_root):
                    got = True
                continue
            dst = os.path.join(dst_root, sub)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                data = self._http_raw(
                    base, f"/v1/client/fs/cat/{alloc_id}?path="
                    + urllib.parse.quote(sub))
            except OSError:
                continue
            with open(dst, "wb") as f:
                f.write(data)
            got = True
        return got

    def _http_json(self, base: str, path: str):
        return json.loads(self._http_raw(base, path) or b"null")

    def _http_raw(self, base: str, path: str) -> bytes:
        if not base.startswith("http"):
            base = "http://" + base
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.read()

    # ---------------------------------------------------------------- misc

    def _migratable_dirs(self) -> list[str]:
        """Task local/ dirs + the shared alloc data dir (ref
        client/allocdir: SharedAllocDir data/, TaskLocal)."""
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job else None
        rels = ["data"]
        if tg:
            rels += [os.path.join(t.name, "local") for t in tg.tasks]
        return rels
