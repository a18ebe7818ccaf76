"""An exact replica of CPython's binary heap (``heapq``), lanes written out.

Port of fks_tpu.ops.heap. The reference's event queue is a ``heapq`` of
``(time, Event)`` tuples, and its retry rule reads the first DELETION in
raw heap-array order (reference: simulator/event_simulator.py:51-58), so
the exact engine keeps CPython's array layout: ``heap_push`` and
``heap_pop`` are CPython's ``_siftdown`` / ``_siftup``, written as "insert
one item into the sorted chain of slots on its path".

Keys are ``(time, tie_rank)`` int32 pairs compared lexicographically
(``tie_rank`` is the pod id's rank in string order, the reference's
``Event.__lt__``); the payload is ``(kind, pod)``. Every operation runs on
all ``L`` lanes at once, is a no-op in a lane whose ``pred`` is False, and
never syncs with the host: its shapes depend only on the capacity.

Storage: ``data i32[L, cap + 1, 4]``, one row ``(time, rank, kind, pod)``
per heap slot, and ``size i32[L]``. PyTorch scatters have no drop mode,
so row ``cap`` is a scratch row: a masked-out write goes there, every read
is clamped to ``cap - 1`` (or reads a row whose value is masked), and the
scratch row never feeds a result. Duplicate scatter indices only ever hit
the scratch row. The operations update ``data`` in place and return the
heap with its new ``size``.

The pop's smaller-child descent is sequential per lane. Instead of one
compare per level, the pop first derives, for every inner slot at once,
the slot it descends to (its smaller live child, or itself when it has no
live child); the path is then one gather per level.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq

import numpy as np
import torch

KIND_CREATE = 0
KIND_DELETE = 1
# scenario fault events (fks_tpu_torch.scenarios): cordon / uncordon a
# node. They ride the same heap with the node index in the pod column and a
# negative rank, so at equal time they pop before every pod event; the
# retry scan below matches KIND_DELETE only, so a fault never anchors a
# retry
KIND_NODE_DOWN = 2
KIND_NODE_UP = 3

# column indices of EventHeap.data
COL_TIME, COL_RANK, COL_KIND, COL_POD = 0, 1, 2, 3


@dataclasses.dataclass
class EventHeap:
    """Array-backed binary min-heaps of scheduling events, one per lane.

    ``data[l, i] == (time, rank, kind, pod)`` of lane l's heap slot i for
    ``i < size[l]``; row ``cap`` is the scratch row (module docstring)."""

    data: torch.Tensor  # i32[L, cap + 1, 4]
    size: torch.Tensor  # i32[L] live element count

    @property
    def capacity(self) -> int:
        return int(self.data.shape[1]) - 1

    @property
    def levels(self) -> int:
        """Max root-to-leaf path length: ceil(log2(cap)) + 1."""
        return (max(self.capacity, 2) - 1).bit_length() + 1

    @property
    def time(self) -> torch.Tensor:
        return self.data[:, :-1, COL_TIME]

    @property
    def rank(self) -> torch.Tensor:
        return self.data[:, :-1, COL_RANK]

    @property
    def kind(self) -> torch.Tensor:
        return self.data[:, :-1, COL_KIND]

    @property
    def pod(self) -> torch.Tensor:
        return self.data[:, :-1, COL_POD]


def _not_less(at, ar, bt, br):
    """``not (a < b)`` for lexicographic (time, rank) keys, i.e. b <= a —
    the reference's tuple compare."""
    return (at > bt) | ((at == bt) & (ar >= br))


def heap_from_events(times, ranks, kinds, pods, capacity: int | None = None,
                     device="cpu") -> EventHeap:
    """A one-lane heap built on the host with CPython ``heapq.heapify``
    itself, so its layout is the reference's (event_simulator.py:23-34)."""
    items = [(int(t), int(r), int(k), int(p))
             for t, r, k, p in zip(times, ranks, kinds, pods)]
    heapq.heapify(items)  # (time, rank) unique per live pod
    n = len(items)
    cap = capacity or n
    if cap < n:
        raise ValueError(f"heap capacity {cap} < {n}")
    arr = np.zeros((1, cap + 1, 4), dtype=np.int32)
    if n:
        arr[0, :n] = np.array(items, dtype=np.int64)
    return EventHeap(data=torch.from_numpy(arr).to(device),
                     size=torch.tensor([n], dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=None)
def _iotas(cap: int, device: torch.device):
    """Index constants of a capacity, made once per (cap, device): levels
    1..lv, 0..lv-1 and 1..lv-1; the inner slots i < cap // 2, their
    children 2i+1 and 2i+2, and the slots cap // 2 .. cap-1."""
    lv = (max(cap, 2) - 1).bit_length() + 1
    half = cap // 2
    a = functools.partial(torch.arange, device=device)
    i = a(half)
    return dict(b=a(1, lv + 1), ks=a(lv), ks1=a(1, lv), i=i, c1=2 * i + 1,
                c2=2 * i + 2, leaves=a(half, cap),
                slots=a(cap, dtype=torch.int32))


def _lanes(x, like: torch.Tensor) -> torch.Tensor:
    """A per-lane operand as a ``[L]`` tensor on ``like``'s device."""
    return torch.as_tensor(x, device=like.device).expand(like.shape[0])


def _rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-gather ``[L, k, 4]`` at ``idx [L, k]``, clamped to the live
    capacity (the scratch row is never read)."""
    i = idx.clamp(0, data.shape[1] - 2)
    return data.gather(1, i[..., None].expand(-1, -1, 4))


def _scatter_rows(data: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> None:
    data.scatter_(1, idx[..., None].expand(-1, -1, 4), rows)


def heap_push(h: EventHeap, time, rank, kind, pod, pred=True) -> EventHeap:
    """``heapq.heappush`` in every lane where ``pred`` holds.

    CPython's ``_siftdown`` bubbles the new item up the ancestor chain of
    slot ``size``, which is sorted root to leaf: the item lands at depth
    ``s`` = number of ancestors <= item, and the deeper ancestors move down
    one level. The chain's slots are arithmetic in ``size``."""
    d = h.data
    cap, lv = h.capacity, h.levels
    k = _iotas(cap, d.device)
    pred = _lanes(pred, d).to(torch.bool)[:, None]
    x = torch.stack([_lanes(v, d).to(torch.int32)
                     for v in (time, rank, kind, pod)], dim=1)  # [L, 4]

    # depth of the insertion slot: e = floor(log2(size + 1))
    pos1 = (h.size.to(torch.int64) + 1)[:, None]
    e = (pos1 >> k["b"] > 0).sum(dim=1, keepdim=True)
    # ancestor chain root -> slot: q_k = ((size + 1) >> (e - k)) - 1
    ks = k["ks"]
    q = (pos1 >> (e - ks).clamp(0, 31)) - 1  # [L, lv]; q_e == size
    valid = ks < e
    v = _rows(d, q)  # [L, lv, 4]
    s = (valid & _not_less(x[:, None, COL_TIME], x[:, None, COL_RANK],
                           v[..., COL_TIME], v[..., COL_RANK])).sum(
        dim=1, keepdim=True)
    # ancestors at depth k in [s, e) move down to q_{k+1}; x goes to q_s
    q_next = torch.cat([q[:, 1:], torch.full_like(q[:, :1], cap)], dim=1)
    tgt = torch.where(valid & (ks >= s) & pred, q_next, cap)
    x_tgt = torch.where(pred, q.gather(1, s.clamp(max=lv - 1)), cap)
    _scatter_rows(d, torch.cat([tgt, x_tgt], dim=1),
                  torch.cat([v, x[:, None]], dim=1))
    return EventHeap(data=d, size=h.size + pred[:, 0].to(torch.int32))


def heap_pop(h: EventHeap, pred=True):
    """``heapq.heappop`` in every lane where ``pred`` holds; elsewhere a
    no-op that returns a garbage item. Returns ``(heap, (time, rank,
    kind, pod))`` with i32[L] item columns; the caller ensures size > 0
    where ``pred`` holds.

    CPython moves the last element into the root hole and runs
    ``_siftup``: descend the smaller-child path to a leaf, shifting each
    child up a level, then ``_siftdown`` the moved item back up the path.
    Net effect: insert the last element into the sorted smaller-child
    chain; items above its insertion depth shift up one level."""
    d = h.data
    cap, lv = h.capacity, h.levels
    k = _iotas(cap, d.device)
    pred = _lanes(pred, d).to(torch.bool)[:, None]
    size = h.size.to(torch.int64)[:, None]
    newsize = (size - 1).clamp(min=0)
    zero = torch.zeros_like(size)
    head_last = _rows(d, torch.cat([zero, newsize], dim=1))  # [L, 2, 4]
    item = head_last[:, 0]
    x = head_last[:, 1]  # the relocated last element

    # where each inner slot i < cap // 2 descends: its smaller live child
    # (ties to the right child, as CPython's `not heap[child] < heap[right]`)
    # or itself when it has no live child; slots >= cap // 2 have none
    half = cap // 2
    left, right = d[:, 1:2 * half:2], d[:, 2:2 * half + 1:2]
    use_right = (k["c2"] < newsize) & _not_less(
        left[..., COL_TIME], left[..., COL_RANK],
        right[..., COL_TIME], right[..., COL_RANK])
    nxt = torch.cat([
        torch.where(k["c1"] < newsize, k["c1"] + use_right, k["i"]),
        k["leaves"].expand(d.shape[0], -1)], dim=1)
    pos, path = zero, [zero]
    for _ in range(lv - 1):
        pos = nxt.gather(1, pos)
        path.append(pos)
    qq = torch.cat(path, dim=1)  # [L, lv]: q_0 = root, q_1..q_{lv-1}
    q, q_prev = qq[:, 1:], qq[:, :-1]
    valid = q != q_prev  # the path moved: level k is live
    v = _rows(d, q)  # [L, lv - 1, 4]
    s = (valid & _not_less(x[:, None, COL_TIME], x[:, None, COL_RANK],
                           v[..., COL_TIME], v[..., COL_RANK])).sum(
        dim=1, keepdim=True)

    # v_k for k in [1, s] shift up to q_{k-1}; x -> q_s
    tgt = torch.where(valid & (k["ks1"] <= s) & pred, q_prev, cap)
    x_tgt = torch.where(pred, qq.gather(1, s), cap)
    _scatter_rows(d, torch.cat([tgt, x_tgt], dim=1),
                  torch.cat([v, x[:, None]], dim=1))
    new_size = torch.where(pred[:, 0], newsize[:, 0], size[:, 0])
    cols = tuple(item[:, k] for k in range(4))
    return EventHeap(data=d, size=new_size.to(torch.int32)), cols


def first_deletion_in_array_order(h: EventHeap):
    """Reference ``repush_creation_event`` scan (event_simulator.py:51-58):
    the first live DELETION in raw backing-array order. Returns
    ``(found bool[L], time i32[L])``; ``time`` is garbage where not
    found."""
    cap = h.capacity
    iota = _iotas(cap, h.data.device)["slots"]
    is_del = (h.data[:, :cap, COL_KIND] == KIND_DELETE) & (
        iota < h.size[:, None])
    pos = torch.where(is_del, iota, cap).amin(dim=1, keepdim=True)
    t = h.data[:, :cap, COL_TIME].gather(1, pos.clamp(max=cap - 1).long())
    return pos[:, 0] < cap, t[:, 0]
