"""The fused UTS engine on an H100: the whole traversal of the seeded
subtrees in one CUDA kernel launch (port of
``hclib_tpu/device/uts_pallas.py`` ``uts_pallas``; kernel in
``csrc/uts.cu``).

``uts_fused`` seeds the tree top on the host (``uts_vec._host_seed``),
stages the roots and the threshold table exactly as ``uts_pallas`` does
(padding, FIXED fast path or per-depth table, stack height, the
depth-bound check) and returns ``uts_pallas``'s result dict, with totals
summed in int64 on the host from per-lane planes.

What differs from ``uts_pallas``:

- On the card one thread is one lane and runs its own DFS, taking roots
  from an atomic counter (no lockstep, no refill rounds). The counts are
  exact and equal the plain engine's; the per-lane planes differ. Its
  ``steps`` is the largest per-lane expansion count, and
  ``lane_efficiency`` = device_nodes / (steps * nlanes) keeps the
  lockstep formula: on the card a finished lane frees its issue slots
  for the others, so it understates how busy the SMs were.
- On ``device="cpu"`` the plain lockstep engine (``uts_vec._uts_dfs``)
  runs instead: there ``steps`` is the JAX engine's lockstep count.
- ``interpret``, ``vmem_limit_bytes``, ``stack_pad``, ``table_cols`` and
  ``min_idle_div`` exist for Mosaic/XLA compiles and the lockstep refill;
  they are dropped. ``lanes`` defaults to ``CARD_LANES`` on the card and
  to the JAX engine's (8, 128) on the CPU; ``target_roots`` to 16 roots a
  lane.
- ``device_seconds`` on the card is one launch's CUDA-event time: the
  inputs and outputs are staged once (``UtsLaunch``), then
  ``timing_reps`` launches (default 3) run back to back after a warm-up
  and the mean is taken; staging and the readback are outside it. On the
  CPU it is the host clock of one run.
- On a CUDA device the kernel runs or the call raises; nothing falls back
  to the plain engine.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..models.uts import UTSParams
from . import uts_vec
from .state import resolve_device

__all__ = ["uts_fused", "uts_dfs", "UtsLaunch", "CARD_LANES", "MAX_STACK"]

# 132 SMs x 8 rows of 128 lanes: 1024 resident threads an SM.
CARD_LANES = (132 * 8, 128)
MAX_STACK = 128  # the deepest stack an instance of the kernel holds
SMEM_MAX = 232448  # shared memory a block may use (H100)


def _words_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the same bits as int32."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


class UtsLaunch:
    """The kernel's inputs and outputs staged on the card once, from
    ``uts_vec._uts_dfs``'s arguments on CUDA tensors: the threshold rows,
    the four per-lane planes and the control words. ``launch()`` only
    enqueues the kernel (counted in ``_build.LAUNCHES["uts"]``);
    ``collect()`` reads the last launch's result back and rearms the
    control words for the next one."""

    def __init__(self, roots_state, roots_count, tab, gen_mx, d0, nroots,
                 stack_size, thresholds, max_steps, lanes):
        dev = roots_state.device
        P = roots_state.shape[1]
        if (dev.type != "cuda" or roots_state.shape != (5, P)
                or roots_state.dtype != torch.int64
                or roots_count.shape != (P,)
                or roots_count.dtype != torch.int32
                or roots_count.device != dev
                or not roots_state.is_contiguous()
                or not roots_count.is_contiguous()):
            raise ValueError("roots must be (5, P) int64 and (P,) int32 on "
                             "one CUDA device")
        if stack_size > MAX_STACK:
            raise ValueError(f"stack height {stack_size} > {MAX_STACK}")
        if thresholds is not None:  # FIXED: one row, guarded by gen_mx
            ktab = torch.tensor([list(thresholds) or [0]],
                                dtype=torch.int32, device=dev)
            lens = torch.tensor([len(thresholds)], dtype=torch.int32,
                                device=dev)
        else:
            ktab = tab.to(dev, torch.int32).contiguous()
            lens = (ktab >= 0).sum(1, dtype=torch.int32)
        trows, tcols = ktab.shape
        if (trows * tcols + trows) * 4 > SMEM_MAX:
            raise ValueError(f"threshold table {trows}x{tcols} exceeds "
                             "shared memory")
        self.dev, self.nroots, self.stack_size = dev, nroots, stack_size
        # Held here: the kernel reads them through raw pointers.
        self._words, self._count, self._ktab, self._lens = (
            _words_i32(roots_state), roots_count, ktab, lens)
        self.planes = [torch.empty(lanes, dtype=torch.int32, device=dev)
                       for _ in range(4)]
        self.ctl = torch.zeros(3, dtype=torch.int32, device=dev)
        self._lib = _build.library("uts")
        self._fn = self._lib.hclib_uts_launch
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        self._args = (
            self._words.data_ptr(), roots_count.data_ptr(), ktab.data_ptr(),
            lens.data_ptr(), *(p.data_ptr() for p in self.planes),
            self.ctl.data_ptr(), P, nroots, d0, gen_mx, trows, tcols,
            int(thresholds is not None), stack_size, lanes[0] * lanes[1],
            min(int(max_steps), 0x7FFFFFFF))

    def launch(self) -> None:
        err = self._fn(*self._args,
                       torch.cuda.current_stream(self.dev).cuda_stream)
        _build.check(self._lib, err, "uts")
        _build.LAUNCHES["uts"] += 1

    def collect(self):
        """Per-lane (nodes, leaves, maxd) planes, steps and whether work
        was left over, as ``uts_vec._uts_dfs`` returns them."""
        c = self.ctl.tolist()
        self.ctl.zero_()
        if c[2]:
            raise RuntimeError(
                f"uts kernel stack overflow (height {self.stack_size})")
        nodes, leaves, maxd, steps = self.planes
        return (nodes, leaves, maxd, int(steps.max()),
                bool(c[1]) or c[0] < self.nroots)

    def time_ms(self, reps: int) -> float:
        """CUDA-event milliseconds of one launch: one warm-up launch, then
        ``reps`` launches back to back, each after the on-stream zeroing
        of its three control words. Leaves the last result for
        ``collect()``."""
        self.launch()
        self.collect()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.ctl.zero_()
            self.launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def uts_dfs(roots_state, roots_count, tab, gen_mx, d0, nroots, stack_size,
            thresholds, max_steps, lanes):
    """The engine over staged roots (``uts_vec._uts_dfs``'s arguments):
    returns per-lane (nodes, leaves, maxd) int32 planes, steps and whether
    work was left over. CUDA tensors launch ``csrc/uts.cu`` once; CPU
    tensors run the plain engine."""
    if roots_state.device.type == "cpu":
        return uts_vec._uts_dfs(roots_state, roots_count, tab, gen_mx, d0,
                                nroots, stack_size, thresholds, max_steps,
                                lanes)
    run = UtsLaunch(roots_state, roots_count, tab, gen_mx, d0, nroots,
                    stack_size, thresholds, max_steps, lanes)
    run.launch()
    return run.collect()


def uts_fused(
    params: UTSParams,
    target_roots: Optional[int] = None,
    max_steps: Optional[int] = None,
    lanes: Optional[Tuple[int, int]] = None,
    depth_bound: Optional[int] = None,
    timing_reps: Optional[int] = None,
    device="cuda",
) -> dict:
    """Count the UTS tree ``params`` exactly: host BFS seeding to
    >= ``target_roots`` frontier nodes, then the engine over the seeded
    subtrees; returns counts and timing (see the module docstring).
    EXPDEC uses ``depth_bound`` (default 8*gen_mx) and raises if the tree
    reaches it; ``max_steps`` caps each lane's expansions (the plain
    engine's lockstep steps on the CPU) and raises when work is left."""
    dev = resolve_device(device)
    if lanes is None:
        lanes = CARD_LANES if dev.type == "cuda" else uts_vec.LANES
    if lanes[1] != 128:
        raise ValueError("uts_fused lanes must be (rows, 128)")
    nlanes = lanes[0] * lanes[1]
    if target_roots is None:
        target_roots = 16 * nlanes
    seed, result = uts_vec.seed_result(params, target_roots)
    if seed[5] is None:
        return result
    if max_steps is None:
        max_steps = (1 << 31) - 1
    sg = uts_vec.stage_roots(params, seed[3], seed[4], seed[5], lanes,
                             depth_bound)
    args, kw = sg.engine_args(dev, max_steps, lanes)
    on_card = dev.type == "cuda"
    reps = uts_vec.resolve_timing_reps(timing_reps, on_card)
    if on_card:
        run = UtsLaunch(*args, **kw)
        dt = run.time_ms(reps) / 1e3
        outs = run.collect()
        dev_nodes = int(outs[0].sum(dtype=torch.int64))
    else:
        outs, dev_nodes, dt = uts_vec.timed_best(
            lambda: uts_dfs(*args, **kw), reps, warm=False)
    return uts_vec.finish_result(result, seed, sg, outs, dev_nodes, dt,
                                 nlanes, "uts_fused", max_steps)
