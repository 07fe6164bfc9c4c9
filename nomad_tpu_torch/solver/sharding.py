"""The solver's device mesh — the counterpart of
nomad_tpu/solver/sharding.py.

One process, one controller. The reference's mesh is one process's
`jax.devices()` under GSPMD; the port's is the device set
`device.devices()` gives (every visible card, or the shard list that
`device.use_devices` installed), driven from this process. A node-axis
tensor on the mesh is a `NodeSharded`: S row blocks of B/S rows, block s
on shard s's `torch.device`. The collectives GSPMD inserts in the
reference are explicit here: each shard launches the hand kernels on its
own block (K1 `depth_curve`, K2 `score_capacity`, their gather entries
and `fit_verdict`, all row-local), and the per-row results are copied
onto the mesh's first device (the lead), where the merge tail (the
stable argsort, the int32 prefix sums, the top-k) runs once on the
gathered vectors in global row order. Row-local kernels and an identical
tail make a sharded solve equal to the solo solve bit for bit. On
several cards the copies are peer copies, ordered by PyTorch's stream
events; on virtual shards (one card listed S times) they are copies on
one device.

Elasticity, as the reference's mesh has it: devices are not immortal.
The mesh carries a generation counter and a quarantine set;
`rebuild(reason, lost_device_ids)` quarantines the lost shards, drops the
singleton so the next `mesh()` spans the survivors (non-power-of-two
counts included: buckets.node_bucket re-pads to the survivor count),
bumps the generation and, outside the mesh lock, invalidates every
mesh-keyed consumer (backend.on_mesh_rebuild, microbatch.on_mesh_rebuild)
and evacuates the state cache's twins (state_cache.TensorCache.evacuate).
`MeshSnapshot` (mesh, generation, shard count in one read) is what the
placer hands through `backend.select()`, so a rebuild in the middle of an
eval cannot split the bucket padding from the launch layout.
`fire_device_loss_sites` is the fault seam: `device.lost.d<N>` fired for
every shard a launch touches, so the whole loss -> quarantine -> rebuild
-> evacuate -> replay path runs on virtual CPU shards in the tests.

When every shard of the set is lost, `lost()` is true and every solve
raises (backend.tier): nothing moves to the CPU that was not asked to.

The sharded solves (each returns a callable with its solo chain's
normalized signature, declared with `sharded_program`'s in/out layouts):
`sharded_fill_greedy` (K2 a shard), `sharded_fill_depth` (K1 a shard),
`sharded_fused` (a shard's gather entry over the rows of `idx` it owns,
then `fit_verdict` over them; the rows it does not own are combined by
select, never by sum), `sharded_place_chunked` (the scan: one launch of
csrc/chunked_shard.cu a device a step, a cluster of 8 CTAs for each of
its shards, every shard ranking the step's offers itself),
`sharded_convex` (the convex solve: one launch of csrc/convex_shard.cu a
device a reduction round, a cluster of 8 x 1,024 threads for each of its
shards, over the eval's rows gathered where their twin rows live,
`gather_node_rows`),
`sharded_preempt_top_k` (the candidate axis split),
`sharded_eval_batch_fill_greedy` (evals over groups of shards, the node
axis over each group's shards), and the explicit cross-shard reduces
`cross_shard_top_k` and `sharded_spread_counts`. Micro-batch windows
split their lanes over the shards where the lane count divides
(`lane_sharding`, `split_lanes`); a fused window over sharded twins runs
each shard's gather entry over the lanes' rows it owns
(`sharded_fused_lanes`). The reference's `sharded_explain_reduce` has no
caller here: the placer explains on the host from the eval's one host
copy.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .. import faults
from ..metrics import metrics
from . import device as _device

NODE_AXIS = "nodes"

# the layouts a sharded program declares for each positional argument
# and each output (sharded_program; the analyzer's SHARD001 checks their
# arity against the program's signature and its returns)
NODE = "node"       # split along axis 0 over the shards
NODE_COLS = "node_cols"     # split along axis 1 (a [stanzas, N] matrix)
REP = "rep"         # the whole value on every shard that reads it
LEAD = "lead"       # the whole value on the mesh's first device
EVALS = "evals"     # split along axis 0 over eval groups of shards
EVALS_NODE = "evals_node"   # [E, N, ...]: evals over the groups, then the
                            # node axis over each group's shards

_mesh_lock = threading.Lock()
_mesh_singleton: "Mesh | None" = None
_generation: int = 0            # bumped by every rebuild()
_quarantined: set[int] = set()  # shard ids removed from the mesh

# Launch serialization (ref `_serialize_launches`): every sharded launch
# sequence — a sharded solve, a twin scatter, a sharded gather, an
# evacuation's salvage — runs under one process-wide lock, so the
# per-device enqueue order is the same on every shard whichever
# scheduler worker or applier thread launches. Re-entrant: a device loss
# caught inside a twin scatter rebuilds the mesh, whose evacuation takes
# the lock again on the same thread.
_launch_lock = threading.RLock()


def launch_lock() -> threading.RLock:
    return _launch_lock


class Shard:
    """One entry of the device set: its stable shard id (the `d<id>` of
    `device.lost.d<id>` and of the quarantine) and its torch device."""

    __slots__ = ("id", "device")

    def __init__(self, sid: int, dev: torch.device):
        self.id = sid
        self.device = dev

    def __repr__(self) -> str:
        return f"Shard(d{self.id}, {self.device})"


class Mesh:
    """A 1-D mesh over shards; `devices` in shard order, `lead` the first
    shard's device (where merge tails run and results meet)."""

    __slots__ = ("devices",)

    def __init__(self, shards):
        self.devices = tuple(shards)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0].device

    @property
    def ids(self) -> tuple:
        return tuple(d.id for d in self.devices)

    def __repr__(self) -> str:
        return f"Mesh({list(self.devices)})"


def all_shards() -> list:
    """Every entry of the device set, quarantined or not."""
    return [Shard(i, d) for i, d in enumerate(_device.devices())]


def healthy_devices() -> list:
    """The shards the mesh may span: every shard not quarantined. Empty
    when the quarantine holds them all (then `lost()`): the port keeps
    no device to fall back on."""
    shards = all_shards()
    if _quarantined:
        shards = [d for d in shards if d.id not in _quarantined]
    return shards


def lost() -> bool:
    """Every shard of the device set is quarantined: solves raise."""
    return bool(_quarantined) and not healthy_devices()


class MeshLostError(RuntimeError):
    """Every shard of the device set is quarantined: the solver has no
    device left to run on (backend.tier raises it). Not a device error:
    nothing classifies, counts or replays it."""


def lane_sharding(n_lanes: int, m: "Mesh | None" = None
                  ) -> "Mesh | None":
    """The mesh a window of `n_lanes` lanes splits its lane axis over (ref
    `lane_sharding`): shard s solves lanes [s L/S, (s + 1) L/S). None
    where there is no mesh or the lanes do not divide over its shards:
    the window then runs solo on the mesh's first device."""
    m = m if m is not None else mesh()
    if m is None or n_lanes % m.size:
        return None
    return m


def lead_id() -> int:
    """The shard id solo work runs under: the first healthy shard's (0 on
    one card)."""
    healthy = healthy_devices()
    return healthy[0].id if healthy else 0


def solo_loss_site(dev: torch.device) -> str:
    """The `device.lost.d<N>` fault site of a solo launch on `dev`: the
    lead shard's when the device set has several shards (solo work runs
    on the mesh's first device), else the card's own index."""
    if len(_device.devices()) > 1:
        return f"device.lost.d{lead_id()}"
    return f"device.lost.d{dev.index or 0}"


def mesh() -> "Mesh | None":
    """The process-wide mesh over every healthy shard, or None when at
    most one healthy shard exists (the solo tiers own that). One mesh
    for the process: the state cache's twins and the sharded solves
    must agree on it."""
    with _mesh_lock:
        return _mesh_locked()


def _mesh_locked() -> "Mesh | None":
    global _mesh_singleton
    devs = healthy_devices()
    if len(devs) <= 1:
        return None
    want = [(d.id, d.device) for d in devs]
    if _mesh_singleton is None or \
            [(d.id, d.device) for d in _mesh_singleton.devices] != want:
        _mesh_singleton = Mesh(devs)
    return _mesh_singleton


class MeshSnapshot:
    """Mesh + generation + shard count captured in ONE read: a solve's
    bucket padding, tier selection and launch layout all describe the
    same device set even when a rebuild lands in the middle of an eval."""

    __slots__ = ("mesh", "generation", "shards")

    def __init__(self, m: "Mesh | None", generation: int):
        self.mesh = m
        self.generation = generation
        self.shards = 1 if m is None else m.size


def snapshot() -> MeshSnapshot:
    with _mesh_lock:
        return MeshSnapshot(_mesh_locked(), _generation)


def generation() -> int:
    """The current mesh generation (monotonic; bumped by rebuild())."""
    return _generation


def quarantined() -> frozenset:
    """Shard ids currently quarantined out of the mesh."""
    return frozenset(_quarantined)


# rebuild reasons are a BOUNDED enum (they feed metric names — OBS001)
_REBUILD_REASONS = ("device_loss", "operator", "test")

# replay ceiling per in-flight dispatch: one replay per generation bump,
# and a cascade can bump at most (shards - 1) times before the mesh is
# solo — the cap is a runaway backstop, not a policy knob
MAX_REPLAYS = 8


def rebuild(reason: str, lost_device_ids=(),
            observed_generation: int | None = None) -> int:
    """Quarantine `lost_device_ids`, drop the mesh singleton (the next
    mesh() spans the survivors) and bump the generation; then, outside
    the mesh lock and in this order, drop every mesh-keyed consumer
    (backend's chains, the micro-batcher's state) and evacuate the state
    cache's twins onto the new mesh. Returns the resulting generation.

    Idempotent under concurrent detection: a caller passing the
    `observed_generation` its dispatch rode is a no-op when a sibling
    already rebuilt past it and every shard it blames is already
    quarantined — K threads watching one shard die cost ONE rebuild."""
    global _generation, _mesh_singleton
    if reason not in _REBUILD_REASONS:
        reason = "operator"
    with _mesh_lock:
        lost_ids = {int(i) for i in lost_device_ids}
        new_lost = lost_ids - _quarantined
        if observed_generation is not None and not new_lost and \
                _generation > observed_generation:
            return _generation          # a sibling already handled this
        _quarantined.update(new_lost)
        quarantined_new = bool(new_lost)
        _generation += 1
        gen = _generation
        _mesh_singleton = None
        metrics.set_gauge("nomad.mesh.generation", gen)
        metrics.set_gauge("nomad.mesh.quarantined_devices",
                          len(_quarantined))
        metrics.incr("nomad.mesh.rebuilds")
        # reason is clamped to the _REBUILD_REASONS enum above — bounded
        # nomadlint: disable=OBS001 — reason clamped to a 3-value enum
        metrics.incr(f"nomad.mesh.rebuilds.{reason}")
    # consumers take their own locks; the mesh lock never nests around
    # them. Caches first: an eval racing the rebuild must not pull a
    # dead-generation chain while the evacuation re-seeds the twins.
    from . import backend, microbatch, state_cache
    backend.on_mesh_rebuild(gen, quarantined_new=quarantined_new)
    microbatch.on_mesh_rebuild(gen)
    state_cache.cache().evacuate(reason=reason)
    return gen


def fire_device_loss_sites(m: "Mesh | None" = None,
                           lead_only: bool = False) -> None:
    """`device.lost.d<N>` fault sites, fired at a dispatch seam's entry
    for each shard the launch touches (every shard of `m`, or of the
    healthy set; only the first with `lead_only`, for solo work on the
    lead), so a test can lose shard N at the n-th dispatch. Costs one
    module-attribute read when no plan is armed."""
    if faults.active() is None:
        return
    devs = list(m.devices) if m is not None else healthy_devices()
    for d in devs[:1] if lead_only else devs:
        faults.fire(f"device.lost.d{d.id}")


def describe() -> dict:
    """The operator debug bundle's Mesh block: generation, quarantine and
    the surviving mesh's shard count."""
    with _mesh_lock:
        m = _mesh_locked()
        return {
            "Generation": _generation,
            "QuarantinedDevices": sorted(_quarantined),
            "HealthyDevices": len(healthy_devices()),
            "Shards": 1 if m is None else m.size,
            "AxisName": NODE_AXIS,
        }


def reset() -> None:
    """Tests that change the device set drop the singleton, the
    quarantine and the generation (consumers reset separately:
    backend.reset, microbatch.reset, state_cache.reset)."""
    global _mesh_singleton, _generation
    with _mesh_lock:
        _mesh_singleton = None
        _generation = 0
        _quarantined.clear()
        metrics.set_gauge("nomad.mesh.generation", 0)
        metrics.set_gauge("nomad.mesh.quarantined_devices", 0)


# --------------------------------------------------- the node-axis layout

def _upload(a: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    """A tensor on `dev` owning a copy of `a` (to a card through pinned
    memory, without blocking)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    dtype = dtype or t.dtype
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True).to(dtype)
    return t.to(dtype=dtype, copy=True)


class NodeSharded:
    """One logical node-axis tensor [B, ...] as S row blocks of B/S rows,
    block s on shard s's device. Never written in place: an advance
    builds new blocks (state_cache), so a reader holding this object
    keeps exactly its bits."""

    __slots__ = ("blocks", "mesh")

    def __init__(self, blocks, m: Mesh):
        self.blocks = tuple(blocks)
        self.mesh = m

    @property
    def rows(self) -> int:
        """Rows a shard."""
        return int(self.blocks[0].shape[0])

    @property
    def shape(self) -> tuple:
        b = self.blocks[0]
        return (self.rows * len(self.blocks),) + tuple(b.shape[1:])

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def lead(self) -> torch.Tensor:
        """The whole tensor on the lead device (one copy a block)."""
        dev = self.mesh.lead
        return torch.cat([b.to(dev, non_blocking=True) for b in self.blocks])

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host (a copy a block): a sharded
        solve's result at its host sync, as a tensor's .cpu() gives it."""
        return torch.cat([b.cpu() for b in self.blocks])

    def sum(self, dtype=None) -> torch.Tensor:
        """The sum of every element, on the lead: each block's sum meets
        there (a refill's placement total)."""
        lead = self.mesh.lead
        return torch.stack([b.sum(dtype=dtype).to(lead)
                            for b in self.blocks]).sum()

    def __repr__(self) -> str:
        return f"NodeSharded({self.shape}, {self.dtype}, {self.mesh})"


def _same_layout(x: NodeSharded, m: Mesh) -> bool:
    return len(x.blocks) == m.size and all(
        b.device == d.device for b, d in zip(x.blocks, m.devices))


def node_blocks(x, m: Mesh, dtype=None, axis: int = 0) -> tuple:
    """`x` (numpy, a tensor anywhere, or a NodeSharded) as m.size blocks
    along `axis`, block s on shard s's device, in `dtype` when given.
    A NodeSharded already in m's layout passes its blocks through: no
    copy, no re-scatter."""
    if isinstance(x, NodeSharded):
        if axis == 0 and _same_layout(x, m) and \
                (dtype is None or x.dtype == dtype):
            return x.blocks
        x = x.lead()
    n = int(x.shape[axis])
    s = m.size
    if n % s:
        raise ValueError(f"axis {axis} of {n} rows does not split over "
                         f"{s} shards")
    r = n // s
    out = []
    for i, d in enumerate(m.devices):
        sl = [slice(None)] * len(x.shape)
        sl[axis] = slice(i * r, (i + 1) * r)
        part = x[tuple(sl)]
        if isinstance(part, np.ndarray):
            out.append(_upload(part, d.device, dtype))
        else:
            part = part.to(device=d.device, dtype=dtype or part.dtype,
                           non_blocking=True)
            out.append(part.contiguous())
    return tuple(out)


def put_node_sharded(arr, m: "Mesh | None" = None, dtype=None):
    """Place a host (or device) [N(, R')] node-axis array on the mesh,
    row blocks over the shards (the state cache's twin seeding). A plain
    tensor on the solve device when there is no mesh."""
    m = m if m is not None else mesh()
    if m is None:
        if isinstance(arr, np.ndarray):
            return _upload(arr, _device.solve_device(), dtype)
        return arr.to(device=_device.solve_device(), dtype=dtype or arr.dtype)
    return NodeSharded(node_blocks(arr, m, dtype), m)


def is_node_sharded(x, m: "Mesh | None" = None) -> bool:
    """Is `x` a node-axis tensor partitioned over more than one shard (of
    `m` when given)? The check behind "twins and chained solves stay
    partitioned"."""
    if not isinstance(x, NodeSharded) or len(x.blocks) <= 1:
        return False
    return m is None or _same_layout(x, m)


def to_host(x) -> np.ndarray:
    """A tensor's or a NodeSharded's values as one numpy array (a copy a
    block)."""
    if isinstance(x, NodeSharded):
        return np.concatenate([b.cpu().numpy() for b in x.blocks])
    return x.cpu().numpy()


def at_lead(x):
    """A sharded solve's node-axis RESULT (a NodeSharded placement or
    verdict, never a twin) as one tensor on the mesh's first device, for
    the eval's one host copy; a tensor passes through."""
    if isinstance(x, NodeSharded):
        return _at_lead(x.mesh, x.blocks)
    return x


class _Replicas:
    """A replicated input, copied to each distinct shard device once."""

    __slots__ = ("value", "dtype", "_on")

    def __init__(self, value, dtype):
        self.value = value
        self.dtype = dtype
        self._on: dict = {}

    def on(self, dev: torch.device) -> torch.Tensor:
        t = self._on.get(dev)
        if t is None:
            v = self.value
            if isinstance(v, torch.Tensor):
                t = v.to(device=dev, dtype=self.dtype,
                         non_blocking=True).contiguous()
            else:
                t = _upload(np.asarray(v), dev, self.dtype)
            self._on[dev] = t
        return t


def _per_shard(m: Mesh, launch) -> list:
    """launch(s, shard) on every shard of `m`, in shard order. An error
    raised by a shard's launch names that shard (`device_id`, unless it
    names one already), so a device loss quarantines the shard it hit."""
    out = []
    for s, d in enumerate(m.devices):
        try:
            out.append(launch(s, d))
        except Exception as e:  # noqa: BLE001 — annotated and re-raised
            if getattr(e, "device_id", None) is None:
                try:
                    e.device_id = d.id
                except AttributeError:
                    pass
            raise
    return out


def _at_lead(m: Mesh, parts) -> torch.Tensor:
    """Per-shard row results, in shard order, as one tensor on the lead."""
    lead = m.lead
    return torch.cat([p.to(lead, non_blocking=True) for p in parts])


def _select_at_lead(m: Mesh, parts, owners) -> torch.Tensor:
    """Per-shard results over the same rows, each valid only where its
    shard owns the row (`owners[s]`, bool on the lead): combined by
    select, so a row comes from exactly one shard."""
    lead = m.lead
    acc = parts[0].to(lead, non_blocking=True)
    for part, own in zip(parts[1:], owners[1:]):
        acc = torch.where(own, part.to(lead, non_blocking=True), acc)
    return acc


def gather_node_rows(twins: tuple, idx, valid, m: Mesh) -> tuple:
    """Rows `idx` of node-sharded twins (each a NodeSharded of R rows a
    shard), in eval order, split over m's shards along the eval's bucket
    axis: the block of shard d holds bucket rows [d B/S, (d + 1) B/S),
    each gathered on the shard that owns its twin row and copied to d,
    rows where `valid` is False zeroed (kernels.gather_rows's values). No
    whole twin and no whole bucket meets on one device. -> one tuple of
    blocks a twin."""
    rows = twins[0].rows
    idx_h = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx,
                       np.int64)
    valid_h = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor)
                         else valid, bool)
    b = idx_h.shape[0]
    if b % m.size:
        raise ValueError(f"a bucket of {b} rows does not split over "
                         f"{m.size} shards")
    r = b // m.size
    owner = idx_h // rows
    out = []
    for twin in twins:
        blocks = twin.blocks if _same_layout(twin, m) else \
            node_blocks(twin, m)
        width = tuple(twin.shape[1:])
        mine = []
        for d, dst in enumerate(m.devices):
            sl = slice(d * r, (d + 1) * r)
            acc = torch.zeros((r,) + width, dtype=twin.dtype,
                              device=dst.device)
            for s in np.unique(owner[sl][valid_h[sl]]):
                pos = np.flatnonzero((owner[sl] == s) & valid_h[sl])
                src = blocks[s]
                got = src.index_select(0, _upload(idx_h[sl][pos] - s * rows,
                                                  src.device))
                acc.index_copy_(0, _upload(pos, dst.device),
                                got.to(dst.device, non_blocking=True))
            mine.append(acc)
        out.append(tuple(mine))
    return tuple(out)


def sharded_program(m: Mesh, ins: tuple, out):
    """Declare a sharded program over `m`: `ins` one layout per
    positional argument (NODE, NODE_COLS, REP, LEAD), `out` the layout of
    its result (a tuple of layouts for a tuple). The program runs under
    the launch lock; a call with another argument count raises. The
    declaration is what SHARD001 holds against the signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            if len(args) != len(ins):
                raise TypeError(f"{fn.__name__} takes {len(ins)} "
                                f"positional arguments ({len(args)} given)")
            with _launch_lock:
                return fn(*args)
        run.in_specs = ins
        run.out_specs = out
        run.mesh = m
        return run
    return wrap


# ------------------------------------------------- cross-shard reduces

def _top_k_desc(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest, ties to the lower index (as
    lax.top_k picks them): a stable descending sort."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def cross_shard_top_k(m: Mesh, k: int):
    """Winner top-k as an explicit two-stage cross-shard reduce: each
    shard takes its own rows' k best, the S*k (score, global index)
    candidates meet on the lead, and the global top-k picks from them
    alone — a global winner is a winner of its own shard. -> fn(score
    f32[N]) -> (values f32[k], indices i32[k]) on the lead."""

    @sharded_program(m, ins=(NODE,), out=(LEAD, LEAD))
    def run(score):
        blocks = node_blocks(score, m, torch.float32)
        n_local = int(blocks[0].shape[0])
        vals, idxs = [], []
        for s, b in enumerate(blocks):
            v, i = _top_k_desc(b, min(k, n_local))
            vals.append(v)
            idxs.append(i + s * n_local)
        vs, gs = _at_lead(m, vals), _at_lead(m, idxs)
        fv, fi = _top_k_desc(vs, min(k, vs.shape[0]))
        return fv, gs[fi].to(torch.int32)
    return run


def sharded_spread_counts(m: Mesh, n_props: int):
    """Spread-stanza running counts as a per-shard bincount plus a sum
    across shards: each shard counts its own nodes' placements per spread
    value, the [S, P] partials add on the lead (int32: exact in any
    order). -> fn(ids i32[S, N] (-1 missing), add i32[N]) -> i32[S, P]."""

    @sharded_program(m, ins=(NODE_COLS, NODE), out=LEAD)
    def run(ids, add):
        id_blocks = node_blocks(ids, m, torch.int32, axis=1)
        add_blocks = node_blocks(add, m, torch.int32)
        parts = []
        for ib, ab in zip(id_blocks, add_blocks):
            safe = ib.clamp(0, n_props - 1).to(torch.int64)
            adds = torch.where(ib >= 0, ab[None, :], 0)
            parts.append(torch.zeros((ib.shape[0], n_props), dtype=torch.int32,
                                     device=ib.device).scatter_add_(1, safe,
                                                                    adds))
        acc = parts[0].to(m.lead)
        for p in parts[1:]:
            acc = acc + p.to(m.lead, non_blocking=True)
        return acc
    return run


# ------------------------------------------------------ the sharded solves

def split_lanes(m: Mesh, lanes_fn, parts: list) -> torch.Tensor:
    """A micro-batch window's lanes split over `m` (lane_sharding): shard
    s runs `lanes_fn(*parts[s])` (its lanes' stacked columns, on its
    device: one launch of the depth-curve kernel and the tail over them),
    and the rows meet on the lead in lane order -> placed i32[L, N]."""
    with _launch_lock:
        return _at_lead(m, _per_shard(m, lambda s, d: lanes_fn(*parts[s])))


def sharded_fill_greedy(m: Mesh):
    """fill_greedy_binpack with the node axis sharded: K2's greedy entry
    on each shard's block (capacity clamped to max_per_node and the sort
    key), the two vectors gathered on the lead, the stable sort +
    prefix-sum take once there. Returns fn(cap, used, ask, count,
    feasible, max_per_node) -> placements i32[N] on the lead."""
    from . import cuda_kernels, kernels

    @sharded_program(m, ins=(NODE, NODE, REP, REP, NODE, REP), out=LEAD)
    def run(cap, used, ask, count, feasible, max_per_node):
        caps = node_blocks(cap, m, torch.float32)
        useds = node_blocks(used, m, torch.float32)
        feas = node_blocks(feasible, m, torch.bool)
        asks = _Replicas(ask, torch.float32)
        capacity, key = zip(*_per_shard(
            m, lambda s, d: cuda_kernels.score_capacity_greedy(
                caps[s], useds[s], asks.on(d.device), feas[s],
                int(max_per_node))))
        return kernels._greedy_fill(_at_lead(m, capacity),
                                    _at_lead(m, key), int(count))
    return run


def sharded_fill_depth(m: Mesh, k_max: int = 128,
                       spread_algorithm: bool = False, depth_grid=None):
    """fill_depth with the node axis sharded: K1 on each shard's block
    (the [rows, K] curves never leave the shard), the (d_star, k_star,
    k_cap) vectors gathered on the lead, then the density order and the
    int32 prefix-sum take once there over the global bucket. The order
    jitter is drawn over the global bucket by the placer and read whole
    by that tail, never per shard. Returns fn(cap, used, ask, count,
    feasible, job_collisions, desired, aff, max_per_node, order_jitter,
    jitter_scale, jitter_samples) -> placements i32[N] on the lead."""
    from . import cuda_kernels, kernels

    @sharded_program(m, ins=(NODE, NODE, REP, REP, NODE, NODE, REP, NODE,
                             REP, NODE, REP, REP), out=LEAD)
    def run(cap, used, ask, count, feasible, job_collisions, desired, aff,
            max_per_node, order_jitter, jitter_scale, jitter_samples):
        caps = node_blocks(cap, m, torch.float32)
        useds = node_blocks(used, m, torch.float32)
        feas = node_blocks(feasible, m, torch.bool)
        colls = node_blocks(job_collisions, m, torch.int32)
        if aff is None:
            affs = tuple(torch.zeros(c.shape[0], dtype=torch.float32,
                                     device=c.device) for c in caps)
        else:
            affs = node_blocks(aff, m, torch.float32)
        asks = _Replicas(ask, torch.float32)
        outs = _per_shard(m, lambda s, d: cuda_kernels.depth_curve(
            caps[s], useds[s], asks.on(d.device), feas[s], colls[s],
            int(desired), affs[s], max_per_node=int(max_per_node),
            k_max=k_max, spread_algorithm=spread_algorithm,
            depth_grid=depth_grid))
        d_star, k_star, k_cap = (_at_lead(m, col) for col in zip(*outs))
        jit = None
        if order_jitter is not None:
            jit = _Replicas(order_jitter, torch.float32).on(m.lead)
        return kernels._depth_order_take_one(
            d_star, k_star, k_cap, int(count), jit,
            float(np.float32(jitter_scale)),
            float(np.float32(jitter_samples)))
    return run


def _owned_rows(m: Mesh, idx, valid, rows: int) -> tuple:
    """Route the eval's rows to the shards that own them: idx holds rows
    of twins split `rows` a shard. -> (owners [S] bool on the lead,
    per-shard local idx [B] and valid [B] on the shard's device; a row a
    shard does not own is masked there: valid False, idx 0)."""
    lead = m.lead
    idx_l = _Replicas(idx, torch.int32).on(lead)
    valid_l = _Replicas(valid, torch.bool).on(lead)
    owner = torch.div(idx_l, rows, rounding_mode="floor")
    owners, idxs, valids = [], [], []
    for s, d in enumerate(m.devices):
        own = owner == s
        owners.append(own)
        idxs.append(torch.where(own, idx_l - s * rows, 0).to(torch.int32)
                    .to(d.device, non_blocking=True))
        valids.append((valid_l & own).to(d.device, non_blocking=True))
    return owners, idxs, valids


def _verdict(m: Mesh, caps, useds, idxs, valids, asks, placed, owners):
    """fit_verdict on each shard over the rows it owns, the verdict rows
    combined by select on the lead. -> (placed, fit) on the lead; on a
    card both views of one buffer, as cuda_kernels.fused_to_host takes
    them."""
    from . import cuda_kernels
    fits = _per_shard(m, lambda s, d: cuda_kernels.fit_verdict(
        caps[s], useds[s], idxs[s], valids[s], asks.on(d.device),
        placed.to(d.device, non_blocking=True))[1])
    fit = _select_at_lead(m, fits, owners)
    if m.lead.type != "cuda":
        return placed, fit
    n = int(placed.shape[0])
    buf = torch.empty((5 * n,), dtype=torch.uint8, device=m.lead)
    placed_out = buf[:4 * n].view(torch.int32)
    fit_out = buf[4 * n:].view(torch.bool)
    placed_out.copy_(placed)
    fit_out.copy_(fit)
    return placed_out, fit_out


def sharded_fused(m: Mesh, kernel: str = "depth", k_max: int = 128,
                  spread_algorithm: bool = False, depth_grid=None):
    """The whole-eval fused program with the resident twins consumed
    partitioned: each shard runs K1's (depth) or K2's (greedy) gather
    entry over the rows of `idx` that it owns, straight from its own twin
    blocks (no re-scatter), the rows it does not own masked; the
    per-row results meet on the lead by select, the tail runs once
    there, and each shard's `fit_verdict` covers its own rows. Returns
    fn(*fused_args) -> (placed i32[B], fit bool[B]) on the lead, the
    fused chain's signature (kernels.fused_eval_depth / _greedy)."""
    from . import cuda_kernels, kernels

    def twins(cap_res, used_res):
        caps = node_blocks(cap_res, m, torch.float32)
        useds = node_blocks(used_res, m, torch.float32)
        return caps, useds, int(caps[0].shape[0])

    if kernel == "depth":
        @sharded_program(m, ins=(NODE, NODE, LEAD, LEAD, REP, REP, REP,
                                 REP, REP, REP, REP, LEAD, REP, REP, REP,
                                 REP), out=(LEAD, LEAD))
        def run(cap_res, used_res, idx, valid, ask, count, feasible, coll,
                desired, aff, mpn, jitter, jscale, jsamples, class_ids, dh):
            del class_ids, dh           # explain runs on the host
            caps, useds, rows = twins(cap_res, used_res)
            owners, idxs, valids = _owned_rows(m, idx, valid, rows)
            asks = _Replicas(ask, torch.float32)
            feas = _Replicas(feasible, torch.bool)
            colls = _Replicas(coll, torch.int32)
            n = int(owners[0].shape[0])
            affs = _Replicas(np.zeros(n, np.float32) if aff is None
                             else aff, torch.float32)
            outs = _per_shard(m, lambda s, d: cuda_kernels.depth_curve_gather(
                caps[s], useds[s], idxs[s][None], valids[s][None],
                asks.on(d.device)[None], feas.on(d.device)[None],
                colls.on(d.device)[None], (int(desired),),
                affs.on(d.device)[None], (int(mpn),), k_max=k_max,
                spread_algorithm=spread_algorithm, depth_grid=depth_grid))
            d_star, k_star, k_cap = (
                _select_at_lead(m, [o[0] for o in col], owners)[None]
                for col in zip(*outs))
            jit = None if jitter is None else \
                _Replicas(jitter, torch.float32).on(m.lead)[None]
            placed = kernels._depth_order_take(
                d_star, k_star, k_cap, (int(count),), jit,
                (float(np.float32(jscale)),),
                (float(np.float32(jsamples)),))[0]
            return _verdict(m, caps, useds, idxs, valids, asks, placed,
                            owners)
        return run
    if kernel == "greedy":
        @sharded_program(m, ins=(NODE, NODE, LEAD, LEAD, REP, REP, REP,
                                 REP, REP, REP, REP), out=(LEAD, LEAD))
        def run_greedy(cap_res, used_res, idx, valid, ask, count, feasible,
                       mpn, class_ids, dh, coll):
            del class_ids, dh, coll     # explain runs on the host
            caps, useds, rows = twins(cap_res, used_res)
            owners, idxs, valids = _owned_rows(m, idx, valid, rows)
            asks = _Replicas(ask, torch.float32)
            feas = _Replicas(feasible, torch.bool)
            capacity, key = zip(*_per_shard(
                m, lambda s, d: cuda_kernels.score_capacity_gather(
                    caps[s], useds[s], idxs[s], valids[s], asks.on(d.device),
                    feas.on(d.device), int(mpn))))
            placed = kernels._greedy_fill(
                _select_at_lead(m, capacity, owners),
                _select_at_lead(m, key, owners), int(count))
            return _verdict(m, caps, useds, idxs, valids, asks, placed,
                            owners)
        return run_greedy
    raise ValueError(f"unknown fused kernel {kernel!r}")


def _fused_lanes_verdict(m: Mesh, caps, useds, idxs, valids, asks, placed,
                         owners):
    """fit_verdict over a window's lanes on each shard (the rows it owns),
    combined by select on the lead -> fit bool[L, B]."""
    from . import cuda_kernels
    fits = _per_shard(m, lambda s, d: cuda_kernels.fit_verdict(
        caps[s], useds[s], idxs[s], valids[s], asks.on(d.device),
        placed.to(d.device, non_blocking=True))[1])
    return _select_at_lead(m, fits, owners)


def sharded_fused_lanes(k_max: int = 128, spread_algorithm: bool = False,
                        depth_grid=None):
    """A fused depth window over node-sharded twins (ref microbatch
    `_fused_fn` under the mesh): on the mesh of the call (its generation's
    survivors after a rebuild), each shard runs ONE launch of K1's gather
    entry over every lane's rows of `idx` that it owns (the rest masked),
    the per-row results meet on the lead by select, the [L, B] tail runs
    once there, and each shard runs ONE fit_verdict launch over its own
    rows. Where the mesh no longer takes the twins' layout (a rebuild
    left a shard count the bucket does not split over), the window runs
    solo on the first device. -> fn(cap_res, used_res, idx [L, B], valid,
    ask [L, R'], counts, feasible, coll, desired, aff, mpn, jitter,
    jitter_scales, jitter_samples) -> (placed i32[L, B], fit bool[L, B])
    on the lead."""
    from . import cuda_kernels, kernels

    def run(cap_res, used_res, idx, valid, ask, counts, feasible, coll,
            desired, aff, mpn, jitter, jitter_scales, jitter_samples):
        m = mesh()
        n_res = int(cap_res.shape[0])
        if m is None or n_res % m.size:
            # the window's columns lie on the solve device (the lead)
            whole = tuple(t.lead() if isinstance(t, NodeSharded) else t
                          for t in (cap_res, used_res))
            if aff is None:
                aff = torch.zeros(idx.shape, dtype=torch.float32,
                                  device=idx.device)
            return cuda_kernels.fused_eval_depth_lanes(
                *whole, idx, valid, ask, counts, feasible, coll, desired,
                aff, mpn, order_jitter=jitter, jitter_scales=jitter_scales,
                jitter_samples=jitter_samples, k_max=k_max,
                spread_algorithm=spread_algorithm, depth_grid=depth_grid)
        caps = node_blocks(cap_res, m, torch.float32)
        useds = node_blocks(used_res, m, torch.float32)
        rows = int(caps[0].shape[0])
        lead = m.lead
        idx_l = _Replicas(idx, torch.int32).on(lead)
        valid_l = _Replicas(valid, torch.bool).on(lead)
        owner = torch.div(idx_l, rows, rounding_mode="floor")
        owners, idxs, valids = [], [], []
        for s, d in enumerate(m.devices):
            own = owner == s
            owners.append(own)
            idxs.append(torch.where(own, idx_l - s * rows, 0)
                        .to(torch.int32).to(d.device, non_blocking=True))
            valids.append((valid_l & own).to(d.device, non_blocking=True))
        asks = _Replicas(ask, torch.float32)
        feas = _Replicas(feasible, torch.bool)
        colls = _Replicas(coll, torch.int32)
        affs = _Replicas(torch.zeros(tuple(idx.shape), dtype=torch.float32)
                         if aff is None else aff, torch.float32)
        outs = _per_shard(m, lambda s, d: cuda_kernels.depth_curve_gather(
            caps[s], useds[s], idxs[s], valids[s], asks.on(d.device),
            feas.on(d.device), colls.on(d.device), desired,
            affs.on(d.device), mpn, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid))
        d_star, k_star, k_cap = (_select_at_lead(m, col, owners)
                                 for col in zip(*outs))
        jit = None if jitter is None else \
            _Replicas(jitter, torch.float32).on(lead)
        placed = kernels._depth_order_take(d_star, k_star, k_cap, counts,
                                           jit, jitter_scales,
                                           jitter_samples)
        return placed, _fused_lanes_verdict(m, caps, useds, idxs, valids,
                                            asks, placed, owners)
    return run


def sharded_place_chunked(m: Mesh, max_steps: int = 256,
                          spread_algorithm: bool = False):
    """place_chunked with the node axis sharded (ref
    `sharded_place_chunked`, the full production signature): each shard
    holds its block of the running usage and placements and its own copy
    of the spread counts and distinct quotas, and every step is one
    launch a device of the sharded step kernel (cuda_kernels.
    chunked_shard: a cluster of 8 CTAs for each shard the device holds;
    max_steps + 1 launches a device queued at once, the steps past the
    solve's end exiting on the device flag). Every shard ranks the S
    offers of a step alike, so no merge runs on the lead.
    Returns fn(cap, used, ask, count, feasible, job_collisions, desired,
    sp_ids, sp_counts, sp_desired, sp_mode, sp_weights, aff, dp_ids,
    dp_remaining, placed_init, max_per_node) -> (placed NodeSharded,
    final_used NodeSharded, spread_counts, distinct_remaining), the
    tables the first shard's copy (every shard's is the same)."""
    from . import cuda_kernels

    @sharded_program(m, ins=(NODE, NODE, REP, REP, NODE, NODE, REP,
                             NODE_COLS, REP, REP, REP, REP, NODE, NODE_COLS,
                             REP, NODE, REP),
                     out=(NODE, NODE, REP, REP))
    def run(cap, used, ask, count, feasible, job_collisions, desired, sp_ids,
            sp_counts, sp_desired, sp_mode, sp_weights, aff, dp_ids,
            dp_remaining, placed_init, max_per_node):
        caps = node_blocks(cap, m, torch.float32)
        rows = int(caps[0].shape[0])
        if aff is None:
            aff = np.zeros(rows * m.size, np.float32)
        if placed_init is None:
            placed_init = np.zeros(rows * m.size, np.int32)
        reps = [_Replicas(a, t) for a, t in (
            (ask, torch.float32), (sp_counts, torch.int32),
            (sp_desired, torch.float32), (sp_mode, torch.int32),
            (sp_weights, torch.float32), (dp_remaining, torch.int32))]
        on = [[r.on(d.device) for d in m.devices] for r in reps]
        out = cuda_kernels.chunked_shard(
            caps, node_blocks(used, m, torch.float32), on[0], int(count),
            node_blocks(feasible, m, torch.bool),
            node_blocks(job_collisions, m, torch.int32), int(desired),
            node_blocks(sp_ids, m, torch.int32, axis=1), on[1], on[2], on[3],
            on[4], node_blocks(aff, m, torch.float32),
            node_blocks(dp_ids, m, torch.int32, axis=1), on[5],
            node_blocks(placed_init, m, torch.int32),
            max_per_node=int(max_per_node), max_steps=max_steps,
            spread_algorithm=spread_algorithm)
        return (NodeSharded(out[0], m), NodeSharded(out[1], m), out[2][0],
                out[3][0])
    return run


def sharded_convex(m: Mesh, spread_algorithm: bool = False,
                   n_classes: int = 0):
    """The convex eval (convex.convex_eval) with the resident twins
    consumed partitioned (ref `sharded_convex`): the eval's bucket rows
    split over the shards (gather_node_rows: each row gathered where its
    twin row lives and sent to the shard that solves it), the sharded
    solve (cuda_kernels.convex_solve_sharded: each round one launch a
    device, a cluster of 8 x 1,024 threads a shard; its waits one a block
    of rounds), K2's greedy entry on each
    shard for the baseline, the rounding and the greedy merge on the
    lead. Returns fn(*convex_eval's positional args) -> (placed
    NodeSharded, fit NodeSharded, iterations, gap, convex_won), the
    scalars on the lead (every shard holds the same)."""
    from . import cuda_kernels
    if n_classes:
        raise ValueError("sharded_convex reduces no explain classes: the "
                         "placer explains on the host")

    @sharded_program(m, ins=(NODE, NODE, REP, REP, REP, REP, NODE, REP,
                             NODE, NODE, NODE, REP, REP, REP, REP, REP),
                     out=(NODE, NODE, REP, REP, REP))
    def run(cap_res, used_res, idx, valid, ask, count, feasible, mpn, aff,
            coll, class_ids, dh, max_iters, tolerance, fairness_weight,
            quota_budget):
        del class_ids, dh           # explain runs on the host
        twins = tuple(t if isinstance(t, NodeSharded)
                      else put_node_sharded(t, m, torch.float32)
                      for t in (cap_res, used_res))
        caps, useds = gather_node_rows(twins, idx, valid, m)
        asks = _Replicas(ask, torch.float32)
        placed, fit, iters, gap, won = cuda_kernels.convex_eval_sharded_fused(
            caps, useds, [asks.on(d.device) for d in m.devices], int(count),
            node_blocks(feasible, m, torch.bool), int(mpn),
            node_blocks(aff, m, torch.float32),
            node_blocks(coll, m, torch.int32), int(max_iters),
            float(np.float32(tolerance)), float(np.float32(fairness_weight)),
            float(np.float32(quota_budget)),
            spread_algorithm=spread_algorithm)
        return (NodeSharded(placed, m), NodeSharded(fit, m), iters, gap, won)
    return run


def sharded_eval_batch_fill_greedy(m: Mesh, eval_groups: int):
    """Batched greedy solves (ref `sharded_eval_batch_fill_greedy`: vmap
    over an eval axis data-parallel, the node axis model-parallel, on a
    2-D evals x nodes mesh). The port's mesh is 1-D: its S shards form
    `eval_groups` groups of S / eval_groups consecutive shards (the groups
    must divide S and the evals); the evals split over the groups in
    order, and each group's shards split the node axis. For each (eval,
    shard) one launch of K2's greedy entry on the shard's block; each
    eval's merge tail (the stable sort and prefix sums) on its group's
    first shard. No caller in the placer, as in the reference. Returns
    fn(cap [E, N, R'], used [E, N, R'], ask [E, R'], count [E], feasible
    [E, N]) -> placed i32[E, N] on the lead."""
    from . import cuda_kernels, kernels
    if eval_groups < 1 or m.size % eval_groups:
        raise ValueError(f"{eval_groups} eval groups do not divide "
                         f"{m.size} shards")
    per = m.size // eval_groups
    groups = [Mesh(m.devices[g * per:(g + 1) * per])
              for g in range(eval_groups)]

    @sharded_program(m, ins=(EVALS_NODE, EVALS_NODE, EVALS, EVALS,
                             EVALS_NODE), out=LEAD)
    def run(cap, used, ask, count, feasible):
        n_evals = int(cap.shape[0])
        if n_evals % eval_groups:
            raise ValueError(f"{n_evals} evals do not split over "
                             f"{eval_groups} groups")
        k = n_evals // eval_groups
        counts = np.asarray(count.cpu() if isinstance(count, torch.Tensor)
                            else count).reshape(-1)
        rows = []
        for e in range(n_evals):
            g = groups[e // k]
            caps = node_blocks(cap[e], g, torch.float32)
            useds = node_blocks(used[e], g, torch.float32)
            feas = node_blocks(feasible[e], g, torch.bool)
            asks = _Replicas(ask[e], torch.float32)
            capacity, key = zip(*_per_shard(
                g, lambda s, d: cuda_kernels.score_capacity_greedy(
                    caps[s], useds[s], asks.on(d.device), feas[s])))
            rows.append(kernels._greedy_fill(
                _at_lead(g, capacity), _at_lead(g, key),
                int(counts[e])).to(m.lead, non_blocking=True))
        return torch.stack(rows)
    return run


def sharded_preempt_top_k(m: Mesh):
    """Batched preemption victim selection with the CANDIDATE-node axis
    sharded: each shard runs its candidates' masked victim scan
    (kernels.preempt_top_k, one torch program, no hand kernel) and the
    masks meet on the lead. The candidate axis pads to a shard multiple
    with all-ineligible candidates, whose masks are empty. Returns
    fn(victim_res, victim_prio, ask, free, job_prio) -> bool[C, V]."""
    from . import kernels

    @sharded_program(m, ins=(NODE, NODE, REP, NODE, REP), out=LEAD)
    def run(victim_res, victim_prio, ask, free, job_prio):
        c = int(victim_res.shape[0])
        pad = (-c) % m.size
        vr = np.pad(np.asarray(victim_res, np.float32),
                    ((0, pad), (0, 0), (0, 0)))
        vp = np.pad(np.asarray(victim_prio, np.int32), ((0, pad), (0, 0)),
                    constant_values=2 ** 20)
        fr = np.pad(np.asarray(free, np.float32), ((0, pad), (0, 0)))
        vrs = node_blocks(vr, m, torch.float32)
        vps = node_blocks(vp, m, torch.int32)
        frs = node_blocks(fr, m, torch.float32)
        asks = _Replicas(ask, torch.float32)
        masks = _per_shard(m, lambda s, d: kernels.preempt_top_k(
            vrs[s], vps[s], asks.on(d.device), frs[s], int(job_prio)))
        return _at_lead(m, masks)[:c]
    return run
