"""Key-hash record exchange over the device mesh.

Counterpart of ``pathway_tpu/parallel/exchange.py``. The shuffle of a
batch of (key, payload) rows is one mesh program (``parallel/spmd.py``):
each shard sorts its rows into per-destination buckets of a fixed
capacity and one ``all_to_all`` moves the buckets. Scalar control traffic
stays on the host; bulk payloads cross between devices (peer-to-peer
copies across cards, none between shards of one card).

Fixed shapes: each shard sends exactly ``capacity + 1`` slots to every
destination. The extra slot of each bucket is a trash slot that no row
is written to: masked-out rows and bucket overflow are counted there,
never shipped, and every slot carries a validity flag.

Routing over the real 128-bit key space: the int64 ``keys`` carried
through the exchange are identifiers, not the routing domain. Callers
pass ``dests``, the destination shard of each row, computed on the host
with the exact 128-bit ``key % n_shards`` (:func:`route128`, the native
``dp_route_key``) or any other content-stable rule, so device routing
agrees bit for bit with the engine's host exchange
(``engine/workers._shard_of``).

Overflow: :func:`exchange_by_key` flags it; :func:`exchange_with_respill`
handles it. The host knows every (source, destination) bucket count, so
it ships rows in ``ceil(max_count / capacity)`` rounds, each sending the
next ``capacity`` rows of every bucket: nothing is dropped and capacity
never grows to the worst case.

Where the JAX package differs by necessity:

* keys ride as int64 (torch has no general uint32 arithmetic), and
  :func:`exchange_columns_with_respill` ships each 64-bit column as one
  int64 lane (a bit-exact view; JAX splits it into two uint32 lanes
  because it truncates 64-bit values by default);
* torch has no buffer donation, so ``donate`` only names the
  single-round layout that :func:`plan_respill_layout` picks for
  near-uniform waves (and the program that runs it); the plan verifier's
  donation rule still guards that decision.

Every dispatch goes through the device plane's program ledger, charged to
bucket ``capacity``: capacity churn shows as new (program, bucket) rows,
while ragged waves of one capacity keep each row at one shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import Mesh, P

__all__ = [
    "ExchangeResult",
    "exchange_by_key",
    "exchange_by_key_checked",
    "exchange_columns_with_respill",
    "exchange_with_respill",
    "partition_counts",
    "plan_respill_layout",
    "route128",
]


class ExchangeResult(NamedTuple):
    keys: torch.Tensor  # [shards, (cap+1) * shards] int64: received keys per slot
    payloads: torch.Tensor  # [shards, (cap+1) * shards, ...]: received payloads
    valid: torch.Tensor  # [shards, (cap+1) * shards] bool: slot occupancy
    # some bucket exceeded capacity: its overflowing rows were not shipped,
    # so rows are MISSING when this is set (exchange_with_respill re-ships)
    overflowed: torch.Tensor  # [] bool


def _bucketize(keys, payloads, dests, valid_in, n_shards: int, cap: int, axis: str):
    """Sort one shard's rows into n_shards buckets of cap+1 slots each.
    A row's slot is its rank among the valid rows of its destination, in
    arrival order; rows past `cap` and masked rows are not written, and
    slot `cap` of each bucket (the trash slot) stays invalid."""
    me = spmd.axis_index(axis)
    dest = torch.where(valid_in, dests, me)  # masked rows stay "local"
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    sorted_valid = valid_in[order]
    # rank within the destination = valid rows of that destination up to
    # this one, minus one (the stable sort keeps arrival order)
    csum = torch.cumsum(sorted_valid.long(), 0)
    per_dest = torch.bincount(sorted_dest, minlength=n_shards)
    starts = torch.cumsum(per_dest, 0) - per_dest
    before = torch.where(
        starts > 0, csum[(starts - 1).clamp(min=0, max=max(len(csum) - 1, 0))], 0
    )
    within = csum - before[sorted_dest] - 1
    fits = sorted_valid & (within < cap)
    overflow = (sorted_valid & (within >= cap)).any()
    width = n_shards * (cap + 1)
    # rows that do not fit go to a scratch slot past the end, sliced away
    slot = torch.where(fits, sorted_dest * (cap + 1) + within, width)
    bucket_keys = keys.new_zeros(width + 1).index_put_((slot,), keys[order])[:width]
    bucket_pay = payloads.new_zeros((width + 1,) + tuple(payloads.shape[1:]))
    bucket_pay = bucket_pay.index_put_((slot,), payloads[order])[:width]
    bucket_valid = torch.zeros(width + 1, dtype=torch.bool, device=keys.device)
    bucket_valid = bucket_valid.index_put_((slot,), fits)[:width]
    return bucket_keys, bucket_pay, bucket_valid, overflow


# mesh -> small stable token for program names: two meshes with the same
# axes and shape must not share one registered program (the program
# closes over its mesh). The lru_cache below keeps every cached mesh
# alive, so tokens never alias live meshes.
_MESH_TOKENS: dict = {}


def _mesh_token(mesh: Mesh) -> int:
    tok = _MESH_TOKENS.get(mesh)
    if tok is None:
        tok = _MESH_TOKENS[mesh] = len(_MESH_TOKENS)
    return tok


@functools.lru_cache(maxsize=64)
def _exchange_program(mesh: Mesh, axis: str, n_shards: int, cap: int, donate: bool = False):
    """One registered exchange program per (mesh, axis, capacity), named
    as in the JAX package; every dispatch charges bucket `cap` on the
    device plane's ledger."""

    def local(k, p, d, v):
        bk, bp, bv, overflow = _bucketize(k, p, d, v, n_shards, cap, axis)
        w = cap + 1
        rk = spmd.all_to_all(bk.view(n_shards, w), axis, 0, 0)
        rp = spmd.all_to_all(bp.view((n_shards, w) + tuple(p.shape[1:])), axis, 0, 0)
        rv = spmd.all_to_all(bv.view(n_shards, w), axis, 0, 0)
        ov = spmd.pmax(overflow.to(torch.int32).view(1), axis)
        return (
            rk.reshape(1, n_shards * w),
            rp.reshape((1, n_shards * w) + tuple(p.shape[1:])),
            rv.reshape(1, n_shards * w),
            ov,
        )

    mapped = spmd.shard_map(local, mesh, in_specs=(P(axis),) * 4, out_specs=(P(axis),) * 4)
    from pathway_tpu_torch.engine.device_plane import get_device_plane

    name = f"exchange.a2a[{axis}]:s{n_shards}:c{cap}:m{_mesh_token(mesh)}" + (
        ":donated" if donate else ""
    )
    prog = get_device_plane().program(name, mapped)

    def dispatch(*args):
        return prog(*args, bucket=cap)

    return dispatch


def _as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype) if dtype is not None else x.to(device)


def exchange_by_key(
    keys,
    payloads,
    mesh: Mesh,
    axis: str = "data",
    capacity: int | None = None,
    dests=None,
    valid=None,
    donate: bool = False,
) -> ExchangeResult:
    """Shuffle rows so shard s receives every row with ``dests == s``
    (default dests: ``keys % n_shards``).

    keys: [n] integer row identifiers; payloads: [n, ...]; rows split
    evenly over the shards in order (n must divide). dests: [n]
    destination shards, which must lie in [0, n_shards) (checked on the
    host for numpy dests; a device scatter would drop the rest without a
    signal); valid: [n] bool row mask (False rows do not ship). Outputs
    keep the shard dimension explicit, on the mesh's first device:
    ``result.keys[s]`` are the slots shard s received.
    """
    n_shards = mesh.shape[axis]
    dev = mesh.device(0)
    rows_total = keys.shape[0]
    if rows_total % n_shards != 0:
        raise ValueError(f"row count {rows_total} not divisible by {n_shards}")
    cap = capacity or rows_total // n_shards
    keys = _as_tensor(keys, dev, torch.int64)
    payloads = _as_tensor(payloads, dev)
    if dests is None:
        dests = keys % n_shards
    elif isinstance(dests, np.ndarray):
        if len(dests) and (dests.min() < 0 or dests.max() >= n_shards):
            raise ValueError(
                f"dests outside [0, {n_shards}): rows would be silently "
                "dropped by the device scatter"
            )
    dests = _as_tensor(dests, dev, torch.int64)
    valid = (
        torch.ones(rows_total, dtype=torch.bool, device=dev)
        if valid is None
        else _as_tensor(valid, dev, torch.bool)
    )
    fn = _exchange_program(mesh, axis, n_shards, cap, donate)
    rk, rp, rv, ov = fn(keys, payloads, dests, valid)
    return ExchangeResult(keys=rk, payloads=rp, valid=rv, overflowed=(ov > 0).any())


def exchange_by_key_checked(
    keys,
    payloads,
    mesh: Mesh,
    axis: str = "data",
    capacity: int | None = None,
    max_retries: int = 3,
) -> ExchangeResult:
    """Legacy wrapper: retries with doubled capacity while `overflowed`.
    Prefer exchange_with_respill (no data loss, bounded memory)."""
    n_shards = mesh.shape[axis]
    cap = capacity or keys.shape[0] // n_shards
    for _ in range(max_retries + 1):
        result = exchange_by_key(keys, payloads, mesh, axis, capacity=cap)
        if not bool(result.overflowed):
            return result
        cap *= 2
    raise RuntimeError(
        f"exchange overflowed even at capacity {cap // 2} per bucket "
        f"({max_retries} retries) — key distribution is pathologically "
        "skewed; pre-aggregate or rebalance keys"
    )


def route128(key_lo: np.ndarray, key_hi: np.ndarray, n_shards: int) -> np.ndarray:
    """Exact destination over the 128-bit key space (key % n_shards),
    identical to engine/workers._shard_of for record keys. Uses the
    native kernel when it is loaded."""
    from pathway_tpu_torch.engine.native import dataplane as dp

    if dp.available():
        return dp.route_key(
            np.ascontiguousarray(key_lo, np.uint64),
            np.ascontiguousarray(key_hi, np.uint64),
            n_shards,
        )
    m = n_shards
    r64 = pow(2, 64, m)
    return np.asarray(
        [(int(hi) % m * r64 + int(lo) % m) % m for lo, hi in zip(key_lo, key_hi)],
        np.int64,
    )


def _verifier_on() -> bool:
    """Plan-verifier gate for the per-wave donation guard: the cached
    mirror (an env read per wave is a banned hot-path pattern)."""
    from pathway_tpu_torch.internals import verifier

    return verifier.enabled_cached()


def plan_respill_layout(
    capacity: int | None, max_bucket: int, per: int, n_shards: int
) -> tuple[bool, int, int, int]:
    """The respill layout decision as a pure function of the wave shape:
    returns (donate, cap, rounds, rows_local).

    Near-uniform waves take a single round sized from the measured max
    bucket: each shard sends n_shards*(max_bucket+1) slots, byte for byte
    the receive layout (the JAX package donates the staging buffers to
    it). Taken only while the staging overhead stays bounded (~25% over
    the real rows; the n_shards^2 floor keeps small waves eligible).
    Skewed waves take the multi-round respill, never "donated": its
    staging tensors are reused across rounds, the invariant that
    internals/verifier.py re-probes over a shape grid."""
    donate = (
        capacity is None
        and max_bucket >= 1
        and n_shards * (max_bucket + 1) <= per + max(per // 4, n_shards * n_shards)
    )
    if donate:
        cap, rounds = max_bucket, 1
        rows_local = n_shards * (cap + 1)
    else:
        cap = capacity or max(min(max_bucket, max(per // 2, 1)), 1)
        rounds = max(1, -(-max_bucket // cap))
        rows_local = max(per, 1)
    return donate, cap, rounds, rows_local


def exchange_with_respill(
    key_ids: np.ndarray,
    payloads: np.ndarray,
    dests: np.ndarray,
    mesh: Mesh,
    axis: str = "data",
    capacity: int | None = None,
):
    """Host-orchestrated multi-round exchange: rows ship in
    ceil(max_bucket / capacity) rounds, each sending at most `capacity`
    rows of every (source, destination) bucket; overflow rows are
    re-spilled to later rounds instead of retrying the whole batch at a
    bigger capacity.

    key_ids: [n] integer identifiers; payloads: [n, ...]; dests: [n]
    exact destination shards (route128 of the full key). Rows are split
    evenly over the source shards in order. Returns (keys_per_dest,
    payload_per_dest, src_index_per_dest): numpy arrays per destination
    shard in global arrival order (each row's original index), the
    engine's same-key ordering invariant: a retraction never overtakes
    the insert it cancels, even across respill rounds.
    """
    n_shards = mesh.shape[axis]
    dev = mesh.device(0)
    n = len(key_ids)
    pos = np.arange(n)
    # contiguous even split of the real rows over source shards; bucket
    # stats come from real rows only, before the padded layout is chosen,
    # so pad rows neither take capacity slots nor add rounds
    per = -(-n // n_shards) if n else 0
    shard = pos // per if n else pos
    dests64 = np.asarray(dests, np.int64)
    if n and (dests64.min() < 0 or dests64.max() >= n_shards):
        raise ValueError(f"dests outside [0, {n_shards})")
    # per-(src, dst) rank: row order is (src-major, arrival) order, so the
    # rank is the running count per (src, dst) pair
    sd = shard * n_shards + dests64
    order = np.argsort(sd, kind="stable")
    sorted_sd = sd[order]
    group_start = np.r_[0, np.nonzero(np.diff(sorted_sd))[0] + 1]
    group_len = np.diff(np.r_[group_start, n])
    within_sorted = np.arange(n) - np.repeat(group_start, group_len)
    within = np.empty(n, np.int64)
    within[order] = within_sorted
    max_bucket = int(group_len.max()) if n else 0
    donate, cap, rounds, rows_local = plan_respill_layout(capacity, max_bucket, per, n_shards)
    if _verifier_on():
        # the donation rule, re-checked at the live decision
        from pathway_tpu_torch.internals.verifier import check_donation

        check_donation(donate, rounds, rows_local, n_shards, cap)
    # per-shard padded layout: shard s holds its run of `per` real rows
    # followed by invalid pad slots up to rows_local
    total = rows_local * n_shards
    padded_pos = shard * rows_local + (pos - shard * per)
    orig_of = np.full(total, -1, np.int64)
    orig_of[padded_pos] = pos
    pk = np.zeros(total, np.int64)
    pk[padded_pos] = key_ids
    ppay = np.zeros((total,) + payloads.shape[1:], payloads.dtype)
    ppay[padded_pos] = payloads
    pdests = np.zeros(total, np.int64)
    pdests[padded_pos] = dests64

    keys_d = torch.from_numpy(pk).to(dev)
    pay_d = torch.from_numpy(ppay).to(dev)
    dest_d = torch.from_numpy(pdests).to(dev)
    acc_pay: list[list] = [[] for _ in range(n_shards)]
    acc_keys: list[list] = [[] for _ in range(n_shards)]
    acc_src: list[list] = [[] for _ in range(n_shards)]
    for r in range(rounds):
        sel = np.zeros(total, bool)
        sel[padded_pos] = (within >= r * cap) & (within < (r + 1) * cap)
        res = exchange_by_key(
            keys_d, pay_d, mesh, axis, capacity=cap, dests=dest_d,
            valid=torch.from_numpy(sel).to(dev), donate=donate,
        )
        if bool(res.overflowed):
            raise RuntimeError("an exchange round overflowed its capacity")
        rk = res.keys.cpu().numpy()
        rp = res.payloads.cpu().numpy()
        rv = res.valid.cpu().numpy()
        for d in range(n_shards):
            # received slot order is (src-major, within-bucket arrival) =
            # ascending padded index among this round's rows for d
            idx = np.nonzero(sel & (pdests == d))[0]
            acc_keys[d].append(rk[d][rv[d]])
            acc_pay[d].append(rp[d][rv[d]])
            acc_src[d].append(orig_of[idx])
    out_keys, out_pay, out_src = [], [], []
    for d in range(n_shards):
        k = np.concatenate(acc_keys[d]) if acc_keys[d] else np.empty(0, np.int64)
        p = (
            np.concatenate(acc_pay[d])
            if acc_pay[d]
            else np.empty((0,) + payloads.shape[1:], payloads.dtype)
        )
        s = np.concatenate(acc_src[d]) if acc_src[d] else np.empty(0, np.int64)
        reorder = np.argsort(s, kind="stable")  # global arrival order across rounds
        out_keys.append(k[reorder].astype(key_ids.dtype, copy=False))
        out_pay.append(p[reorder])
        out_src.append(s[reorder])
    return out_keys, out_pay, out_src


def exchange_columns_with_respill(
    columns: "list[np.ndarray]",
    dests: np.ndarray,
    mesh: Mesh,
    axis: str = "data",
    capacity: int | None = None,
):
    """Shuffle a set of aligned 64-bit scalar columns (a NativeBatch's
    key_lo, key_hi, token and diff, plus any other numeric columns) to
    their destination shards in one collective a round: each column is
    one int64 lane (a bit-exact view) of an [n, k] payload matrix.
    Returns ``(cols_per_dest, src_per_dest)``: for every destination
    shard, the columns back in their input dtypes and the original row
    indices, both in global arrival order."""
    if not columns:
        raise ValueError("need at least one column")
    n = len(columns[0])
    dtypes = []
    lanes = []
    for c in columns:
        c = np.ascontiguousarray(c)
        if c.dtype.itemsize != 8 or c.ndim != 1 or len(c) != n:
            raise ValueError(f"columns must be flat 64-bit arrays of {n} rows, got {c.dtype} {c.shape}")
        dtypes.append(c.dtype)
        lanes.append(c.view(np.int64))
    payload = np.stack(lanes, axis=1) if n else np.empty((0, len(columns)), np.int64)
    ids = np.arange(n, dtype=np.int64)
    _keys, pays, srcs = exchange_with_respill(
        ids, payload, np.asarray(dests, np.int64), mesh, axis, capacity
    )
    cols_per_dest = [
        [np.ascontiguousarray(pays[d][:, j]).view(dtypes[j]) for j in range(len(columns))]
        for d in range(mesh.shape[axis])
    ]
    return cols_per_dest, srcs


def partition_counts(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Histogram of destination shards (keys % n_shards): the host
    scheduler reads skew from it before choosing a capacity."""
    if isinstance(keys, np.ndarray):
        keys = torch.from_numpy(keys.astype(np.int64))
    return torch.bincount(keys.long() % n_shards, minlength=n_shards)
