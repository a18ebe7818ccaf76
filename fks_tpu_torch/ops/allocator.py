"""GPU sub-allocation: pick WHICH GPUs of the chosen node a pod gets.

Port of fks_tpu.ops.allocator, batched over any leading dims. Returns a
boolean selection over the node's GPU slots.
"""
from __future__ import annotations

import torch

_BIG = 2**30


def best_fit_gpus(milli_left, gpu_mask, gpu_milli_req, num_gpu):
    """Best fit: the ``num_gpu`` eligible GPUs with the LEAST free milli,
    ties by ascending slot — lexicographic (milli, slot) order, as the
    reference's stable sort gives.

    Args: milli_left i32[..., G], gpu_mask bool[..., G], gpu_milli_req and
    num_gpu i32[...]. Returns (select bool[..., G], ok bool[...]); ``ok``
    is False when fewer than ``num_gpu`` GPUs are eligible."""
    g = milli_left.shape[-1]
    iota = torch.arange(g, dtype=milli_left.dtype, device=milli_left.device)
    eligible = gpu_mask & (milli_left >= gpu_milli_req[..., None])
    key = torch.where(eligible, milli_left * g + iota, _BIG)
    # eligible keys are distinct, so a key's rank is the count below it
    rank = (key[..., None, :] < key[..., :, None]).sum(dim=-1)
    select = eligible & (rank < num_gpu[..., None])
    ok = eligible.sum(dim=-1) >= num_gpu
    return select, ok


def first_fit_gpus(milli_left, gpu_mask, gpu_milli_req, num_gpu):
    """First fit: the first ``num_gpu`` eligible GPUs in slot order."""
    eligible = gpu_mask & (milli_left >= gpu_milli_req[..., None])
    rank = torch.cumsum(eligible.to(torch.int32), dim=-1) - 1
    select = eligible & (rank < num_gpu[..., None])
    ok = eligible.sum(dim=-1) >= num_gpu
    return select, ok
