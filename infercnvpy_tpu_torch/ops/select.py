"""Exact per-row selects (counterpart of ``infercnvpy_tpu/ops/pallas_select.py``).

``row_median``, ``row_median_weighted`` and ``row_kth_smallest``.  The
medians have ``np.median`` semantics: for an even count they are the mean of
the two middle values (``torch.median`` would return the lower one).

Float ordering trick shared by both versions: for IEEE-754, mapping the
integer bit pattern ``i`` to ``key = i XOR (0x7FF..F AND (i >> bits-1))``
makes signed-integer order match total float order (negatives have their
lower bits flipped; -0 sorts just below +0).  The map is an involution.

* the ``*_plain`` versions sort the keys (any device, f32 or f64);
* the ``*_cuda`` versions launch ``csrc/row_median.cu`` and
  ``csrc/row_select.cu`` (f32, CUDA): a 4-pass radix select over the keys
  with (weighted) 256-bin histograms.  Each select has two variants, chosen
  by width: up to :data:`WARP_MAX_WIDTH` values one warp a row, the row
  staged by a bulk copy and its keys held in registers, the weighted
  median's weights in a table in shared memory (``csrc/warp_select.cuh``),
  above it one block a row on
  the block select that the fused and gene kernels also run
  (``csrc/select.cuh``).  All return results bit-identical to the plain
  versions on the same input;
* :func:`radix_select_emulated` repeats the block routine's arithmetic
  (digits, histograms, bin scan, the two ranks of an even total) in numpy,
  :func:`warp_select_emulated` the warp routine's, weighted or not (lane
  layout, histogram copies, the list of the chosen bins, the upper middle),
  :func:`warp_row_walk`
  / :func:`persistent_grid` the rows each warp takes and
  :func:`row_stage_split` the staging of a row, so the CPU tests can hold them
  against the key-sort versions.

Each dispatcher takes the kernel for a CUDA tensor (f32 only; anything else
raises) and the plain version for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = [
    "row_median", "row_median_plain", "row_median_cuda",
    "row_median_weighted", "row_median_weighted_plain", "row_median_weighted_cuda",
    "row_kth_smallest", "row_kth_smallest_plain", "row_kth_smallest_cuda",
    "float_key", "key_to_float", "radix_select_emulated", "median_ranks",
    "select_variant", "warp_select_emulated", "warp_row_walk", "persistent_grid", "lane_slots",
    "row_stage_split",
]

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}

#: threads of a block of the block-a-row select kernels (a multiple of 32, at most 1024)
THREADS = 256
#: warps of a block of the warp-a-row select kernels (``kWarpsPerBlock`` of ``csrc/warp_select.cuh``)
WARPS = 4
RADIX_BITS = 8  #: ``kRadixBits`` of ``csrc/select.cuh``
WARP_MAX_KEYS = 64  #: ``kWarpMaxKeys`` of ``csrc/warp_select.cuh``: keys a lane holds
WARP_MAX_WIDTH = 32 * WARP_MAX_KEYS  #: widest row of the warp kernels (``kWarpMaxWidth``)
WARP_STAGE = WARP_MAX_WIDTH + 4  #: floats of a warp's row stage (``kWarpStage``)
WARP_COPIES = 4  #: ``kCopies``: copies of the first pass's histogram
#: ``kListPairs``: (key, weight) pairs the weighted select's list holds (its scratch: the 4 copies' ints)
WARP_LIST_PAIRS = (WARP_COPIES * ((1 << RADIX_BITS) + 4) - (1 << RADIX_BITS)) // 2
WARP_NARROW_TOTAL = 0xFFFF  #: the largest weight total for which the weighted warp kernel's weight table is 16-bit


def float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving signed-integer key of each float's bit pattern."""
    itype = _INT_OF[x.dtype]
    bits = torch.iinfo(itype).bits
    i = x.contiguous().view(itype)
    return i ^ (torch.iinfo(itype).max & (i >> (bits - 1)))


def key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`float_key`."""
    itype = _INT_OF[dtype]
    bits = torch.iinfo(itype).bits
    i = key ^ (torch.iinfo(itype).max & (key >> (bits - 1)))
    return i.contiguous().view(dtype)


def row_median_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of a 2-D f32/f64 tensor by sorting the float keys."""
    n, w = x.shape
    if n == 0 or w == 0:
        return torch.zeros((n,), dtype=x.dtype, device=x.device)
    keys = torch.sort(float_key(x), dim=1).values
    k = w // 2
    hi = key_to_float(keys[:, k], x.dtype)
    if w % 2 == 1:
        return hi
    lo = key_to_float(keys[:, k - 1], x.dtype)
    return (lo + hi) / 2


def _check_cuda_f32(x: torch.Tensor, name: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D float32 CUDA tensor, got {x.dtype} on {x.device}")
    return x.contiguous()


def select_variant(width: int) -> str:
    """Which kernel variant a row of ``width`` values takes: ``"warp"`` up to :data:`WARP_MAX_WIDTH`, else ``"block"``.

    This is dispatch on shape: both variants are hand-written kernels with
    the same results; a row that fits a warp's registers (64 keys a lane)
    takes the warp kernel, a wider one the block-a-row kernel.
    """
    return "warp" if width <= WARP_MAX_WIDTH else "block"


def _count(fn, variant: str) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] += 1


def row_median_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of a 2-D f32 CUDA tensor (kernels of ``row_median.cu``)."""
    x = _check_cuda_f32(x, "row_median_cuda")
    n, w = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or w == 0:
        return out.zero_()
    lib = _build.library()
    variant = select_variant(w)
    with torch.cuda.device(x.device):
        stream = _build.current_stream(x.device)
        if variant == "warp":
            err = lib.row_median_warp_launch(x.data_ptr(), out.data_ptr(), n, w, stream)
        else:
            err = lib.row_median_launch(x.data_ptr(), out.data_ptr(), n, w, THREADS, stream)
    _build.check(err, f"row_median ({variant})")
    _count(row_median_cuda, variant)
    return out


row_median_cuda.launches = 0
row_median_cuda.launches_by_variant = {"warp": 0, "block": 0}


def row_median(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median: the CUDA kernel for a CUDA tensor, the plain sort on the CPU.

    A CUDA tensor that is not f32 raises (the kernel takes f32 only).
    """
    if x.is_cuda:
        return row_median_cuda(x)
    return row_median_plain(x)


def _weights(weights, w: int, device) -> tuple[torch.Tensor, int]:
    """``(int64 weights on device, total)``; raises on a bad shape or a negative weight.

    Weights given on the host are checked there, before their one upload;
    weights on a device are checked there, the sign test and the total read
    back in one wait.
    """
    device = torch.device(device)
    on_device = isinstance(weights, torch.Tensor) and weights.device.type != "cpu"
    wts = weights.to(device=device, dtype=torch.int64) if on_device else torch.as_tensor(weights).to(torch.int64)
    if tuple(wts.shape) != (w,):
        raise ValueError(f"weights must have shape ({w},), got {tuple(wts.shape)}")
    if on_device:
        negative, total = torch.stack([(wts < 0).any().to(torch.int64), wts.sum()]).tolist()
    else:
        negative, total = bool((wts < 0).any()), int(wts.sum())
    if negative:
        raise ValueError("weights must be >= 0")
    if on_device or device.type == "cpu":
        return wts, total
    # from pinned memory: the copy queues without waiting for the device
    return wts.pin_memory().to(device, non_blocking=True), total


def row_median_weighted_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row ``np.median(np.repeat(row, weights))`` of a 2-D f32/f64 tensor.

    ``weights`` — (w,) non-negative integers; a zero weight drops its column.
    A weight total of 0, or no rows, gives zeros.  Sorts the float keys and
    finds ranks ``total // 2`` (and the one below it for an even total) in the
    running weight sum.
    """
    n, w = x.shape
    wts, total = _weights(weights, w, x.device)
    if n == 0 or total == 0:
        return torch.zeros((n,), dtype=x.dtype, device=x.device)
    keys, order = torch.sort(float_key(x), dim=1)
    cum = torch.cumsum(wts[order], dim=1)

    def rank(r: int) -> torch.Tensor:
        # first sorted position whose running weight exceeds r: it has weight > 0
        target = torch.full((n, 1), r + 1, dtype=cum.dtype, device=x.device)
        pos = torch.searchsorted(cum, target)
        return key_to_float(keys.gather(1, pos)[:, 0], x.dtype)

    k_hi = total // 2
    hi = rank(k_hi)
    if total % 2 == 1:
        return hi
    return (rank(k_hi - 1) + hi) / 2


def row_median_weighted_cuda(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row weighted median of a 2-D f32 CUDA tensor (kernels of ``row_select.cu``).

    Up to :data:`WARP_MAX_WIDTH` columns the warp kernel (its weight table
    16-bit where the total is at most :data:`WARP_NARROW_TOTAL`, else
    32-bit), above it the block kernel.
    """
    x = _check_cuda_f32(x, "row_median_weighted_cuda")
    n, w = x.shape
    wts, total = _weights(weights, w, x.device)
    if total > torch.iinfo(torch.int32).max:
        raise ValueError(f"weight total {total} does not fit the kernel's int32 counts")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or total == 0:
        return out.zero_()
    wts = wts.to(torch.int32)
    lib = _build.library()
    variant = select_variant(w)
    with torch.cuda.device(x.device):
        stream = _build.current_stream(x.device)
        if variant == "warp":
            err = lib.row_median_weighted_warp_launch(x.data_ptr(), wts.data_ptr(), out.data_ptr(), n, w, total, stream)
        else:
            err = lib.row_median_weighted_launch(
                x.data_ptr(), wts.data_ptr(), out.data_ptr(), n, w, total, THREADS, stream)
    _build.check(err, f"row_median_weighted ({variant})")
    _count(row_median_weighted_cuda, variant)
    return out


row_median_weighted_cuda.launches = 0
row_median_weighted_cuda.launches_by_variant = {"warp": 0, "block": 0}


def row_median_weighted(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row ``np.median(np.repeat(row, weights))``: the kernel on CUDA, the plain sort on the CPU."""
    if x.is_cuda:
        return row_median_weighted_cuda(x, weights)
    return row_median_weighted_plain(x, weights)


def _check_k(k: int, w: int) -> int:
    k = int(k)
    if not 0 <= k < w:
        raise ValueError(f"k={k} is outside [0, {w}): a row of {w} values has no such element")
    return k


def row_kth_smallest_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest (0-based) of a 2-D f32/f64 tensor by sorting the float keys."""
    n, w = x.shape
    k = _check_k(k, w)
    keys = torch.sort(float_key(x), dim=1).values
    return key_to_float(keys[:, k], x.dtype)


def row_kth_smallest_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest of a 2-D f32 CUDA tensor (kernels of ``row_select.cu``)."""
    x = _check_cuda_f32(x, "row_kth_smallest_cuda")
    n, w = x.shape
    k = _check_k(k, w)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    variant = select_variant(w)  # as for the median: the warp kernel up to WARP_MAX_WIDTH values
    with torch.cuda.device(x.device):
        stream = _build.current_stream(x.device)
        if variant == "warp":
            err = lib.row_kth_smallest_warp_launch(x.data_ptr(), out.data_ptr(), n, w, k, stream)
        else:
            err = lib.row_kth_smallest_launch(x.data_ptr(), out.data_ptr(), n, w, k, THREADS, stream)
    _build.check(err, f"row_kth_smallest ({variant})")
    _count(row_kth_smallest_cuda, variant)
    return out


row_kth_smallest_cuda.launches = 0
row_kth_smallest_cuda.launches_by_variant = {"warp": 0, "block": 0}


def row_kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest (0-based): the kernel on CUDA, the plain sort on the CPU."""
    if x.is_cuda:
        return row_kth_smallest_cuda(x, k)
    return row_kth_smallest_plain(x, k)


def median_ranks(total: int) -> tuple[int, int]:
    """The two 0-based ranks an ``np.median`` over ``total`` values averages (equal for an odd total)."""
    k_hi = total // 2
    return (k_hi if total % 2 else k_hi - 1), k_hi


def _scan_bins(hist: np.ndarray, k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row: the smallest bin ``d`` with ``hist[:d + 1].sum() > k``, and ``k`` minus the bins before it."""
    cum = np.cumsum(hist, axis=1)
    if not (cum[:, -1] > k).all():
        raise ValueError("rank beyond the weight the histogram holds")
    d = (cum > k[:, None]).argmax(axis=1)
    before = np.where(d > 0, cum[np.arange(len(d)), np.maximum(d - 1, 0)], 0)
    return d, k - before


def radix_select_emulated(x: np.ndarray, weights, rank_lo: int, rank_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/select.cuh::block_select2`` in numpy: per row the elements of ranks ``rank_lo <= rank_hi``.

    ``x`` is (rows, w) float32; ``weights`` is ``None`` (every value counts
    once) or (w,) non-negative integers (value ``i`` counts ``weights[i]``
    times, zero drops it).  Most-significant-digit radix select on the
    order-preserving unsigned keys, :data:`RADIX_BITS` bits a pass: a pass
    adds the weight of every value that still matches a rank's prefix to that
    rank's histogram, then scans the bins for the digit holding the rank.  The
    two ranks share a histogram while their prefixes agree and get one each
    from the pass after the one in which they part.  Returns the two (rows,)
    float32 arrays; both are elements of the row, bit for bit.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, w = x.shape
    wts = np.ones(w, np.int64) if weights is None else np.asarray(weights, dtype=np.int64)
    i = x.view(np.int32)
    key = (i ^ (0x7FFFFFFF & (i >> 31))).view(np.uint32) ^ np.uint32(0x80000000)
    live = np.broadcast_to(wts > 0, key.shape)
    wmat = np.broadcast_to(wts, key.shape)
    bins = 1 << RADIX_BITS
    row_of = np.broadcast_to(np.arange(rows)[:, None], key.shape)
    pre = {"lo": np.zeros(rows, np.uint32), "hi": np.zeros(rows, np.uint32)}
    k = {"lo": np.full(rows, rank_lo, np.int64), "hi": np.full(rows, rank_hi, np.int64)}
    for p in range(32 // RADIX_BITS):
        shift = 32 - RADIX_BITS * (p + 1)
        above = np.uint32(0) if p == 0 else np.uint32((0xFFFFFFFF << (shift + RADIX_BITS)) & 0xFFFFFFFF)
        digit = ((key >> np.uint32(shift)) & np.uint32(bins - 1)).astype(np.int64)
        parted = pre["lo"] != pre["hi"]
        in_hi = live & ((key & above) == pre["hi"][:, None])
        in_lo = live & ~in_hi & parted[:, None] & ((key & above) == pre["lo"][:, None])
        hist = {}
        for name, member in (("hi", in_hi), ("lo", in_lo)):
            h = np.zeros((rows, bins), np.int64)
            np.add.at(h, (row_of[member], digit[member]), wmat[member])
            hist[name] = h
        hist["lo"] = np.where(parted[:, None], hist["lo"], hist["hi"])
        for name in ("hi", "lo"):
            d, k[name] = _scan_bins(hist[name], k[name])
            pre[name] = pre[name] | (d.astype(np.uint32) << np.uint32(shift))
    out = []
    for name in ("lo", "hi"):
        s = (pre[name] ^ np.uint32(0x80000000)).view(np.int32)
        out.append((s ^ (0x7FFFFFFF & (s >> 31))).view(np.float32))
    return out[0], out[1]


def row_stage_split(offset: int, width: int) -> tuple[int, int, int]:
    """``csrc/warp_select.cuh::row_stage_split``: ``(m, head, body)`` for a row ``offset`` floats past a 16-byte boundary.

    Values ``0 .. head`` and ``head + body .. width`` are loaded by lanes,
    ``head .. head + body`` by one bulk copy of ``4 * body`` bytes (a multiple
    of 16) from a 16-byte boundary; value ``i`` goes to ``stage[m + i]``.
    """
    m = offset & 3
    head = min((4 - m) & 3, width)
    return m, head, (width - head) & ~3


def persistent_grid(rows: int, warps: int, sms: int, blocks_per_sm: int) -> int:
    """``csrc/warp_select.cuh::launch_warp_rows``'s grid: the blocks that fit the card at once, no more than needed."""
    return max(1, min(sms * blocks_per_sm, -(-rows // warps)))


def warp_row_walk(grid: int, warps: int, rows: int) -> list[np.ndarray]:
    """The rows each warp of ``csrc/warp_select.cuh::warp_select_rows`` selects, warp ``b * warps + w`` at index ``b * warps + w``."""
    stride = grid * warps
    return [np.arange(g, rows, stride) for g in range(stride)]


def lane_slots(width: int) -> np.ndarray:
    """Per lane of a warp, the slots that hold a value of a ``width``-value row (``mine`` of ``warp_select2``)."""
    return (width - np.arange(32) + 31) >> 5


def _short_list_ranks(keys, wmat, listed, r_lo):
    """``warp_wselect2``'s one-step rank of a list of at most 32 keys: ``(short, lo, hi)`` per row.

    Each listed key's sum is the weight of the listed keys at most it; the
    lower key is the least whose sum exceeds ``r_lo``, the upper the least
    whose sum exceeds ``r_lo + 1`` (a key of weight 0 never is: a key of
    weight above 0 at most it has the same sum).
    """
    rows = keys.shape[0]
    short = listed.sum(axis=(1, 2)) <= 32
    lo = np.full(rows, 0xFFFFFFFF, np.uint32)
    hi = lo.copy()
    for r in np.flatnonzero(short):
        k, w = keys[r][listed[r]], wmat[r][listed[r]]
        at_most = (np.where(k[None, :] <= k[:, None], w[None, :], 0)).sum(axis=1)
        lo[r] = np.where(at_most > r_lo[r], k, np.uint32(0xFFFFFFFF)).min(initial=0xFFFFFFFF)
        hi[r] = np.where(at_most > r_lo[r] + 1, k, np.uint32(0xFFFFFFFF)).min(initial=0xFFFFFFFF)
    return short, lo, hi


def warp_select_emulated(x: np.ndarray, rank_lo: int, rank_hi: int, weights=None) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/warp_select.cuh::warp_select2`` (``warp_wselect2`` with ``weights``) in numpy.

    Per row the elements of ranks ``rank_lo`` and ``rank_hi``: ``rank_hi`` is
    ``rank_lo`` (one rank) or ``rank_lo + 1`` (the two middles of an even
    total).  ``x`` is (rows, w) float32 with ``w <=`` :data:`WARP_MAX_WIDTH`;
    ``weights`` is ``None`` (every value counts once) or (w,) non-negative
    integers (value ``i`` counts ``weights[i]`` times, zero drops it).  Lane
    ``l`` holds the keys of values ``j * 32 + l`` in its slots ``j``, each slot
    with its weight; the slots of a lane from :func:`lane_slots` on weigh 0.
    The first pass adds each slot's weight to copy ``l % 4`` of a 256-bin
    histogram at its key's top digit, and the scan sums the copies.  The
    row's keys in bins ``d_lo .. d_hi`` (one unsigned compare; no key of
    weight above 0 lies between them) go into a list in slot-then-lane order
    with their weights, 0 included.  A weighted list of at most 32 keys is
    ranked in one step (:func:`_short_list_ranks`); a longer one, and every
    unweighted list, goes through passes 2-4, which select ``rank_lo`` in the
    list with one histogram (a weighted list of more than
    :data:`WARP_LIST_PAIRS` keys does not fit its shared memory, and the
    kernel runs those passes over the row read again: the same keys, the
    same sums).  ``rank_hi``'s key is then ``rank_lo``'s again if the weight
    of the row's keys at most it exceeds ``rank_lo + 1``, else the least
    listed key of weight above 0 above it.  Returns the two (rows,) float32
    arrays, bit for bit the elements of the row.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, w = x.shape
    if not 1 <= w <= WARP_MAX_WIDTH:
        raise ValueError(f"a warp holds 1 to {WARP_MAX_WIDTH} values, got {w}")
    if rank_hi not in (rank_lo, rank_lo + 1):
        raise ValueError(f"rank_hi must be rank_lo or rank_lo + 1, got {rank_lo}, {rank_hi}")
    bins = 1 << RADIX_BITS
    top_shift = np.uint32(32 - RADIX_BITS)
    i = x.view(np.int32)
    flat = (i ^ (0x7FFFFFFF & (i >> 31))).view(np.uint32) ^ np.uint32(0x80000000)
    # keys[row, j, lane] = key of value j * 32 + lane (0 where there is none), wt[j, lane] its weight
    keys = np.zeros((rows, WARP_MAX_WIDTH), np.uint32)
    keys[:, :w] = flat
    keys = keys.reshape(rows, WARP_MAX_KEYS, 32)
    wt = np.zeros(WARP_MAX_WIDTH, np.int64)
    wt[:w] = 1 if weights is None else np.asarray(weights, dtype=np.int64)
    wt = wt.reshape(WARP_MAX_KEYS, 32)
    valid = np.arange(WARP_MAX_KEYS)[:, None] < lane_slots(w)[None, :]
    assert not wt[~valid].any()  # a slot past the row weighs 0
    live = np.broadcast_to(wt > 0, keys.shape)
    r_, j_, l_ = np.nonzero(live)

    # first pass: copy l % 4 of the histogram for lane l, summed by the scan
    copies = np.zeros((rows, WARP_COPIES, bins), np.int64)
    np.add.at(copies, (r_, l_ % WARP_COPIES, (keys[r_, j_, l_] >> top_shift).astype(np.int64)), wt[j_, l_])
    first = copies.sum(axis=1)
    d_lo, r_lo = _scan_bins(first, np.full(rows, rank_lo, np.int64))
    d_hi, _ = _scan_bins(first, np.full(rows, rank_hi, np.int64))

    # the list: the row's keys of bins d_lo .. d_hi (one unsigned compare, wrapping: all 256 bins give ~0)
    base = d_lo.astype(np.uint32) << top_shift
    last = ((d_hi - d_lo + 1).astype(np.uint32) << top_shift) - np.uint32(1)
    listed = valid & ((keys - base[:, None, None]) <= last[:, None, None])
    if weights is None and listed.sum(axis=(1, 2)).max(initial=0) > WARP_MAX_WIDTH:
        raise AssertionError("the list outgrew its shared memory")

    # passes 2-4 over the list for rank_lo, one histogram
    rows_of = np.broadcast_to(np.arange(rows)[:, None, None], keys.shape)
    wmat = np.broadcast_to(wt, keys.shape)
    short = _short_list_ranks(keys, wmat, listed, r_lo) if weights is not None else None
    pre, k = base, r_lo
    for p in range(1, 32 // RADIX_BITS):
        shift = 32 - RADIX_BITS * (p + 1)
        above = np.uint32((0xFFFFFFFF << (shift + RADIX_BITS)) & 0xFFFFFFFF)
        add = listed & ((keys & above) == pre[:, None, None])
        hist = np.zeros((rows, bins), np.int64)
        digit = ((keys[add] >> np.uint32(shift)) & np.uint32(bins - 1)).astype(np.int64)
        np.add.at(hist, (rows_of[add], digit), wmat[add])
        d, k = _scan_bins(hist, k)
        pre = pre | (d.astype(np.uint32) << np.uint32(shift))
    lo, hi = pre, pre
    if rank_hi != rank_lo:
        at_most = np.where(listed & (keys <= pre[:, None, None]), wmat, 0).sum(axis=(1, 2)) + rank_lo - r_lo
        above = listed & live & (keys > pre[:, None, None])
        above_min = np.where(above, keys, np.uint32(0xFFFFFFFF)).min(axis=(1, 2))
        hi = np.where(at_most > rank_lo + 1, pre, above_min)
    if short is not None:
        # a weighted list of at most 32 keys is ranked in one step instead
        is_short, short_lo, short_hi = short
        lo = np.where(is_short, short_lo, lo)
        hi = np.where(is_short, short_hi if rank_hi != rank_lo else short_lo, hi)
    out = []
    for key in (lo, hi):
        s = (key ^ np.uint32(0x80000000)).view(np.int32)
        out.append((s ^ (0x7FFFFFFF & (s >> 31))).view(np.float32))
    return out[0], out[1]
