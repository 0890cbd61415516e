"""Shared checks and ctypes plumbing for the CUDA kernel wrappers."""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch


def check(t: torch.Tensor, name: str, dtypes: Sequence[torch.dtype],
          ndim: int, device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dims on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{list(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def on_device(index: int):
    """A context that makes card ``index`` current for a launch; none where
    it already is (switching costs host time on every call)."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def raise_on_error(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


# CUDA's limit on gridDim.y, the block axis of the tiled slab / grid tq kernel
MAX_GRID_Y = 65535

# H100: shared memory a block can use, where the properties do not say
SMEM_OPTIN = 232_448


def card(device_index: int) -> Tuple[int, int]:
    """(SM count, shared memory a block can opt in to) of a card."""
    props = torch.cuda.get_device_properties(device_index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN))


def contiguous_items(units: int, per_unit: int, grid: int):
    """The (unit, tile) pairs, unit-major, cut into ``grid`` contiguous
    ranges: -> (items (unit, first tile, end tile, 1), first item of each
    block)."""
    total = units * per_unit
    items, block_items = [], []
    for b in range(grid):
        block_items.append(len(items))
        pos, end = b * total // grid, (b + 1) * total // grid
        while pos < end:
            unit = pos // per_unit
            stop = min(end, (unit + 1) * per_unit)
            items.append((unit, pos - unit * per_unit,
                          stop - unit * per_unit, 1))
            pos = stop
    block_items.append(len(items))
    return items, block_items


# A unit's partials are summed in one level up to this many, else in groups
# of about sqrt(items): no block then reads more than ~2 sqrt(items) of them.
FOLD_GROUP = 16


def fold_plan(items, units: int):
    """How a plan's partial sums are added up: ``items`` are (unit, first
    tile, end tile, tile step), unit-major. -> (the items with a partial
    slot and a group appended, groups, first group of each unit, slots).

    A unit's sole item writes the output itself (slot and group -1). The
    items of any other unit take consecutive slots, cut into groups of
    consecutive items: (first slot, slots, slot of the group's sum), the
    last -1 where the unit has one group (its sum is the output). A unit's
    group sums take consecutive slots after its items'.
    """
    first = [0] * (units + 1)
    for k, item in enumerate(items):
        first[item[0] + 1] = k + 1
    out, groups, unit_groups, slots = [], [], [], 0
    for u in range(units):
        own = items[first[u]:first[u + 1]]
        unit_groups.append(len(groups))
        if len(own) == 1:
            out.append((*own[0], -1, -1))
            continue
        size = (len(own) if len(own) <= FOLD_GROUP
                else math.isqrt(len(own) - 1) + 1)
        n_groups = math.ceil(len(own) / size)
        sums = slots + len(own) if n_groups > 1 else -1
        for g in range(n_groups):
            part = own[g * size:(g + 1) * size]
            groups.append((slots + g * size, len(part),
                           sums + g if n_groups > 1 else -1))
            out.extend((*item, slots + g * size + j, len(groups) - 1)
                       for j, item in enumerate(part))
        slots += len(own) + (n_groups if n_groups > 1 else 0)
    unit_groups.append(len(groups))
    return tuple(out), tuple(groups), tuple(unit_groups), slots


def plan_table(device_index: int, *tables) -> torch.Tensor:
    """A plan's tables (of ints, or of tuples of ints), flattened in this
    order into one int32 tensor on the card."""
    flat = []
    for t in tables:
        for v in t:
            flat.extend(v if isinstance(v, tuple) else (v,))
    return torch.tensor(flat, dtype=torch.int32,
                        device=torch.device("cuda", device_index))


def table_pointers(table: torch.Tensor, *lengths: int):
    """ctypes pointers to consecutive int32 runs of ``lengths`` in
    ``table``, the first at its start."""
    ptrs, at = [], table.data_ptr()
    for n in lengths:
        ptrs.append(ctypes.c_void_p(at))
        at += 4 * n
    return tuple(ptrs)


def workspace(cache: Dict, device_index: int, stream: int, tickets: int,
              floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tickets, partials) of at least these sizes for launches on one
    stream: int32 tickets that every launch leaves at zero, so they are
    zeroed once, and f32 scratch for the partial sums. ``cache`` is the
    wrapper's own dict, keyed by (device, stream): launches on one stream
    run in order, so they can share one buffer."""
    key = (device_index, stream)
    have = cache.get(key)
    if have is None or have[0].numel() < tickets or have[1].numel() < floats:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        dev = torch.device("cuda", device_index)
        have = (torch.zeros(max(tickets, old[0]), dtype=torch.int32,
                            device=dev),
                torch.empty(max(floats, old[1]), dtype=torch.float32,
                            device=dev))
        cache[key] = have
    return have
