"""CUDA wrapper for the Hopper ELL gossip kernel (``csrc/ell_spmm.cu``).

out[i] = diag[i] z[i] + sum_l val[i, l] q(z[idx[i, l]]), f32 accumulation;
q rounds each message to bf16 and back where ``quantise``. A leading batch
axis (a stacked ``SparseW``: B sub-networks of N nodes each) is one launch:
every member is summed exactly as a launch of it alone would sum it.
Replaces ``ell_spmm_pallas`` (``repro/kernels/ell_spmm.py``). Call through
``ops.ell_spmm``.

A block stages a band of rows of z, with ``halo`` rows either side, in
shared memory and gathers the slots that point there from it; the others
read device memory. The band's slot indices and weights are staged beside
the window where they fit, else read from device memory as each row is
summed. Band and halo are properties of the graph, chosen once from its
host-side indices (``window_plan``, which ``SparseW`` calls when it is
built); ``plan`` turns them and the shapes into the launch, a pure
function of both. A batched launch takes one window for all its members,
the one whose cost summed over the members is least.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import _launch

__all__ = ["ell_spmm_cuda", "Plan", "plan", "window_plan", "WindowPlan",
           "BANDS", "HALOS", "ROUTE_LAUNCHES", "reset_route_launches"]

THREADS = 256
TILE_COLS = 256                 # widest column tile: 32 lanes x 8 columns
BANDS = (64, 32, 16, 8)         # rows a block may own
HALOS = (0, 2, 4, 8, 16)        # rows staged either side of a band
# shared memory a block may take: four blocks an SM on an H100
SMEM_BUDGET = 228 * 1024 // 4 - 1024
SMEM_LIMIT = 200 * 1024         # the kernel's dynamic shared memory at most
# a message read from device memory counts this many staged rows
GATHER_COST = 2

# launches by form: one matrix, or a batch of them (a stacked SparseW)
ROUTE_LAUNCHES: Dict[str, int] = {"single": 0, "batched": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def _smem(rows: int, halo: int, tile_cols: int, width: int) -> int:
    """The kernel's shared memory: the window, and for a ``width`` > 0 each
    slot's index and weight and the diagonal."""
    slots = rows * (2 * width + 1) if width else 0
    return 4 * ((rows + 2 * halo) * tile_cols + slots)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """A graph's staging: bands of ``band_rows`` rows with ``halo`` rows
    either side; ``in_window`` of the ``slots`` slots read the window, the
    rest device memory."""
    band_rows: int
    halo: int
    in_window: int
    slots: int

    @property
    def in_window_share(self) -> float:
        return self.in_window / self.slots

    @property
    def gathers(self) -> int:
        """Slots whose message is read from device memory."""
        return self.slots - self.in_window


def _in_window(idx: np.ndarray, rows: int, halo: int) -> int:
    """Slots of ``idx`` ((B,) N, L) whose source lies in their band's
    window (the band, ``halo`` rows either side, clipped at 0 and N - 1)."""
    n = idx.shape[-2]
    r0 = np.arange(n) // rows * rows
    lo = np.maximum(r0 - halo, 0)[:, None]
    hi = np.minimum(r0 + rows + halo, n)[:, None]
    return int(((idx >= lo) & (idx < hi)).sum())


def window_plan(ell_idx: np.ndarray) -> WindowPlan:
    """The band and halo for which the rows a round stages plus
    GATHER_COST times the messages read from device memory are fewest,
    among those whose shared memory at the widest tile fits SMEM_BUDGET
    with the band's slots staged, or, where none does (a wide graph), with
    the window alone; from the host-side (N, L) indices alone (ties: the
    wider band, then the smaller halo). Indices (B, N, L) of a stack plan
    one window for all B members: staged rows and gathers summed over
    them."""
    idx = np.asarray(ell_idx)
    members = idx.shape[0] if idx.ndim == 3 else 1
    n, width = idx.shape[-2:]
    for slot_width in (width, 0):
        best = None
        for rows in BANDS:
            for halo in HALOS:
                if _smem(rows, halo, TILE_COLS, slot_width) > SMEM_BUDGET:
                    continue
                inside = _in_window(idx, rows, halo)
                staged = members * sum(
                    min(n, r0 + rows + halo) - max(0, r0 - halo)
                    for r0 in range(0, n, rows))
                cost = staged + GATHER_COST * (idx.size - inside)
                if best is None or cost < best[0]:
                    best = (cost, WindowPlan(rows, halo, inside, idx.size))
        if best is not None:
            return best[1]
    raise ValueError("no ELL window fits the shared-memory budget")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: bands of ``band_rows`` rows (``halo`` rows either side
    staged with them) by column tiles of ``tile_cols``, for each of
    ``batch`` members; block b takes band ``b % bands`` of tile
    ``b // bands % tiles`` of member ``b // (bands * tiles)``. ``staged``:
    the band's slots and diagonal in shared memory beside the window, else
    read from device memory."""
    band_rows: int
    halo: int
    tile_cols: int
    bands: int
    tiles: int
    vec: bool
    staged: bool
    smem: int
    batch: int = 1

    @property
    def blocks(self) -> int:
        return self.batch * self.bands * self.tiles

    def member(self, b: int) -> int:
        """The member of the batch that block b sums."""
        return b // (self.bands * self.tiles)

    def block(self, b: int, n: int, k: int):
        """(rows, columns, window rows) of block b within its member
        (``member``) as ranges, as the kernel cuts them."""
        b %= self.bands * self.tiles
        band, tile = b % self.bands, b // self.bands
        r0 = band * self.band_rows
        r1 = min(n, r0 + self.band_rows)
        c0 = tile * self.tile_cols
        return (range(r0, r1), range(c0, min(k, c0 + self.tile_cols)),
                range(max(0, r0 - self.halo), min(n, r1 + self.halo)))


@functools.lru_cache(maxsize=256)
def _params(n: int, k: int, width: int, window: Tuple[int, int], vec: bool,
            quantise: bool, batch: int):
    """The launch's host parameters (csrc/ell_spmm.cu ``ell_spmm_launch``)
    as one ctypes array."""
    p = plan(n, k, width, window, vec, batch)
    values = (n, k, width, int(quantise), p.band_rows, p.halo, p.tile_cols,
              int(p.vec), int(p.staged), p.smem, p.batch)
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, width: int, window: Tuple[int, int],
         vec: bool, batch: int = 1) -> Plan:
    """The launch for ``batch`` (n, width) ELL matrices over (n, k)
    payloads with this (band, halo) window; ``vec``: the 16-byte route
    (k % 4 == 0, aligned pointers). Column tiles are as even as the tile
    limit allows (3920 columns: 16 tiles of 248). The band's slots are
    staged where they fit SMEM_BUDGET beside the window. Every member
    takes the same blocks, so a member's bits are those of a launch of it
    alone."""
    if batch < 1:
        raise ValueError(f"an ELL launch takes a batch of at least 1, got "
                         f"{batch}")
    rows, halo = window
    tiles = math.ceil(k / TILE_COLS)
    step = 4 if vec else 1
    cols = -(-math.ceil(k / tiles) // step) * step
    staged = _smem(rows, halo, cols, width) <= SMEM_BUDGET
    smem = _smem(rows, halo, cols, width if staged else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"an ELL window of {rows} rows and a halo of "
                         f"{halo} needs {smem} bytes of shared memory, "
                         f"above {SMEM_LIMIT}")
    return Plan(rows, halo, cols, math.ceil(n / rows), math.ceil(k / cols),
                vec, staged, smem, batch)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/ell_spmm.cu) with its C signature set."""
    lib.ell_spmm_launch.argtypes = [ctypes.c_void_p] * 7
    lib.ell_spmm_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import _build
    return _typed(_build.load("ell_spmm"))


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def ell_spmm_cuda(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                  diag: torch.Tensor, z: torch.Tensor, *,
                  window: WindowPlan, quantise: bool = False
                  ) -> torch.Tensor:
    """ell_idx: (N, L) int32, ell_val: (N, L) f32, diag: (N,) f32, z:
    (N, K) f32, all contiguous on one CUDA device -> (N, K) f32; or a
    batch of B such matrices in one launch: ell_idx / ell_val (B, N, L),
    diag (B, N), z (B, N, K) -> (B, N, K). ``quantise`` rounds each
    gathered message to bf16 (a bf16 payload); the own term stays f32.
    ``window``: the graph's staging (``SparseW.window``, for a batch the
    stack's). It moves the time, never the bits.

    The indices are trusted to lie in [0, N): ``SparseW`` builds them
    from the graph, and checking them here would cost a device sync.
    """
    dev = z.device
    batched = z.dim() == 3
    lead = 1 if batched else 0
    _launch.check(ell_idx, "ell_idx", (torch.int32,), 2 + lead, dev)
    _launch.check(ell_val, "ell_val", (torch.float32,), 2 + lead, dev)
    _launch.check(diag, "diag", (torch.float32,), 1 + lead, dev)
    _launch.check(z, "z", (torch.float32,), 2 + lead, dev)
    *batch, n, k = z.shape
    width = ell_idx.shape[-1]
    if (ell_idx.shape[:-1] != z.shape[:-1] or ell_val.shape != ell_idx.shape
            or diag.shape != z.shape[:-1]):
        raise ValueError(f"shapes do not align: idx {tuple(ell_idx.shape)}, "
                         f"val {tuple(ell_val.shape)}, diag "
                         f"{tuple(diag.shape)}, z {tuple(z.shape)}")
    out = torch.empty(z.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    params = _params(n, k, width, (window.band_rows, window.halo),
                     k % 4 == 0 and _aligned(z, out), quantise,
                     batch[0] if batched else 1)
    with _launch.on_device(dev.index if dev.index is not None
                           else torch.cuda.current_device()):
        err = _lib().ell_spmm_launch(
            ell_idx.data_ptr(), ell_val.data_ptr(), diag.data_ptr(),
            z.data_ptr(), out.data_ptr(), params, _launch.stream(dev))
    _launch.raise_on_error(err, "ell_spmm_launch")
    ROUTE_LAUNCHES["batched" if batched else "single"] += 1
    return out
