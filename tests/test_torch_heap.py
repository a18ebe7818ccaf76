"""fks_tpu_torch.ops.heap vs CPython heapq and fks_tpu.ops.heap.

Random push/pop sequences run on several lanes at once, each lane with its
own operations and a mixed ``pred`` (a False lane must not change). After
every few operations the live backing array and size of every lane equal
Python ``heapq``'s list and fks_tpu's heap; popped items and the first
DELETION in array order agree too. Mirrors tests/test_heap.py.
"""
import heapq
import random

import jax
import numpy as np
import pytest
import torch

from fks_tpu.ops import heap as jheap
from fks_tpu_torch.ops.heap import (
    KIND_CREATE, KIND_DELETE, EventHeap, first_deletion_in_array_order,
    heap_from_events, heap_pop, heap_push,
)
from fks_tpu_torch.testing import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


LANES = 5


def lane_tuples(h: EventHeap, lane: int):
    n = int(h.size[lane])
    return [tuple(int(v) for v in row) for row in h.data[lane, :n]]


def jax_tuples(h):
    n = int(h.size)
    return [tuple(int(v) for v in row) for row in np.asarray(h.data)[:n]]


def stacked(heaps):
    return EventHeap(data=torch.cat([h.data for h in heaps]),
                     size=torch.cat([h.size for h in heaps]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_layout_parity_across_lanes(seed):
    rng = random.Random(seed)
    n0, cap = 50, 50 + 64
    py, jx, init = [], [], []
    for lane in range(LANES):
        times = [rng.randrange(0, 40) for _ in range(n0)]  # many ties
        ranks = list(range(n0))
        rng.shuffle(ranks)
        kinds = [KIND_CREATE] * n0
        pods = list(range(n0))
        items = list(zip(times, ranks, kinds, pods))
        heapq.heapify(items)
        py.append(items)
        jx.append(jheap.heap_from_events(times, ranks, kinds, pods,
                                         capacity=cap))
        init.append(heap_from_events(times, ranks, kinds, pods,
                                     capacity=cap))
    h = stacked(init)
    jpush, jpop = jax.jit(jheap.heap_push), jax.jit(jheap.heap_pop)
    next_rank = n0
    for step in range(150):
        if step % 5 == 0:
            found, t = first_deletion_in_array_order(h)
            for lane in range(LANES):
                assert lane_tuples(h, lane) == py[lane], (step, lane)
                assert lane_tuples(h, lane) == jax_tuples(jx[lane])
                want = [it[0] for it in py[lane] if it[2] == KIND_DELETE]
                assert bool(found[lane]) == bool(want)
                if want:
                    assert int(t[lane]) == want[0]
        pred = [rng.random() < 0.7 for _ in range(LANES)]
        if rng.random() < 0.5:
            items = []
            for lane in range(LANES):
                item = (rng.randrange(0, 40), next_rank,
                        rng.choice([KIND_CREATE, KIND_DELETE]), next_rank)
                next_rank += 1
                items.append(item)
                if pred[lane]:
                    heapq.heappush(py[lane], item)
                    jx[lane] = jpush(jx[lane], *item)
            cols = torch.tensor(items, dtype=torch.int32).T
            h = heap_push(h, *cols, pred=torch.tensor(pred))
        else:
            pred = [p and bool(py[lane]) for lane, p in enumerate(pred)]
            h, item = heap_pop(h, pred=torch.tensor(pred))
            for lane in range(LANES):
                if pred[lane]:
                    want = heapq.heappop(py[lane])
                    jx[lane], jitem = jpop(jx[lane])
                    got = tuple(int(c[lane]) for c in item)
                    assert got == want == tuple(int(v) for v in jitem)
    assert h.size.tolist() == [len(x) for x in py]


def test_push_pred_false_is_noop():
    h = heap_from_events([5, 3], [0, 1], [0, 0], [0, 1], capacity=8)
    before = h.data.clone()
    h2 = heap_push(h, 1, 9, KIND_DELETE, 7, pred=False)
    assert lane_tuples(h2, 0) == [(3, 1, 0, 1), (5, 0, 0, 0)]
    assert int(h2.size[0]) == 2
    assert torch.equal(h2.data[:, :-1], before[:, :-1])  # live rows only


def test_pop_pred_false_is_noop():
    h = heap_from_events([5, 3, 4], [0, 1, 2], [0, 0, 1], [0, 1, 2])
    before = h.data.clone()
    h2, _ = heap_pop(h, pred=False)
    assert int(h2.size[0]) == 3
    assert torch.equal(h2.data[:, :-1], before[:, :-1])


def test_equal_time_orders_by_rank():
    # same time: ranks decide (reference Event.__lt__ on pod_id)
    h = heap_from_events([7, 7, 7], [2, 0, 1], [0, 0, 0], [10, 11, 12])
    pods = []
    for _ in range(3):
        h, (t, r, k, p) = heap_pop(h)
        pods.append(int(p[0]))
    assert pods == [11, 12, 10]
    assert int(h.size[0]) == 0


def test_lanes_are_independent():
    """Four pushes then four pops per lane, as tests/test_heap.py's vmapped
    case (same times, same expected order), on two lanes at once."""
    times = torch.tensor([[4, 1, 3, 2], [9, 9, 0, 5]], dtype=torch.int32)
    h = EventHeap(data=torch.zeros((2, 9, 4), dtype=torch.int32),
                  size=torch.zeros(2, dtype=torch.int32))
    for i in range(4):
        h = heap_push(h, times[:, i], i, KIND_CREATE, i)
    out = []
    for _ in range(4):
        h, (t, _, _, _) = heap_pop(h)
        out.append(t)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  [[1, 2, 3, 4], [0, 5, 9, 9]])


def test_from_events_matches_fks_tpu_layout():
    rng = np.random.default_rng(4)
    times = rng.integers(0, 30, 200)
    ranks = rng.permutation(200)
    kinds = np.zeros(200, np.int32)
    pods = np.arange(200)
    h = heap_from_events(times, ranks, kinds, pods, capacity=256)
    jh = jheap.heap_from_events(times, ranks, kinds, pods, capacity=256)
    np.testing.assert_array_equal(h.data[0, :-1].numpy(), np.asarray(jh.data))
    assert h.capacity == 256 and h.levels == jh.levels
    with pytest.raises(ValueError, match="capacity"):
        heap_from_events(times, ranks, kinds, pods, capacity=100)
