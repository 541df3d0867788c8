"""The vector (subtree) dispatch tier: a recursive task family runs its
whole subtree across lanes (port of ``hclib_tpu/device/vector_engine.py``).

A family that is recursive (its tasks spawn tasks of the same family) and
reduction-shaped (results combine by addition into accumulators) is
described by a ``VectorTaskSpec``. Popping one descriptor of such a family
expands its whole subtree over a (rows, cols) grid of lanes: each lane runs
a tail-call DFS over its own stack of frames, one task a lane a step, and
starved lanes steal the bottom frame of the lane a rotating ring pairs them
with (a rotation is a bijection, so every donor is robbed at most once).

``make_subtree_runner`` here is the plain version, torch ops over
(rows, cols) int32 planes that follow JAX's ``step``, ``balance`` and
``run`` word for word (``torch.roll`` in place of ``jnp.roll``), so a run
cut at any ``max_steps`` gives JAX's ``(nodes, accs, over)``. The kernel is
the CUDA subtree engine in ``csrc/vector.cuh``: inside the megakernel it is
the body of the families compiled there (``VECTOR_BODIES``), and
``subtree_run`` launches it standalone (with ``max_steps``), which the card
tests and ``chip_smoke.py`` use to hold truncated runs against this plain
version. A spec's ``name`` names its compiled family; the spec callables
take the ops namespace as JAX's do (``child(frame, k, torch)``) and return
int32 planes. On the card only the compiled families run; user-defined
bodies are ROADMAP A4.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import _build
from .state import resolve_device

__all__ = ["VectorTaskSpec", "make_subtree_runner", "subtree_run",
           "fib_spec", "nqueens_spec", "VECTOR_BODIES", "MAX_LANES"]

# The families compiled into csrc/vector.cuh, by spec name.
VECTOR_BODIES = ("vfib", "vnqueens")
# Frame words of each compiled family (its frame layout is fixed there).
_FRAME_WORDS = {"vfib": 1, "vnqueens": 3}
# Lanes the CUDA engine holds: 4 a thread on its 256-thread block.
MAX_LANES = 1024
NO_LIMIT = (1 << 31) - 1


def _i32(x: int) -> int:
    return ((int(x) + 0x80000000) % 0x100000000) - 0x80000000


class VectorTaskSpec:
    """A recursive, reduction-shaped task family for the vector tier
    (JAX's ``VectorTaskSpec``; see its docstring for each field).
    ``seed(args)`` maps the 6 descriptor arg words (ints) to the root's
    ``(frame words, child count)``; ``child(frame, k, ops)`` and
    ``contrib(frame, count, ops)`` work on int32 planes. ``param`` is the
    compiled family's static parameter (the board size of ``vnqueens``)."""

    def __init__(
        self,
        name: str,
        frame_words: int,
        seed: Callable,
        child: Callable,
        contrib: Callable,
        accumulators: Sequence[str],
        out_acc: Optional[str] = None,
        stack_depth: int = 34,
        lanes: Tuple[int, int] = (8, 128),
        min_idle_div: int = 8,
        root_contrib: Optional[Callable] = None,
        param: int = 0,
    ) -> None:
        self.name = name
        self.frame_words = frame_words
        self.seed = seed
        self.child = child
        self.contrib = contrib
        self.accumulators = tuple(accumulators)
        self.out_acc = out_acc if out_acc is not None else (
            self.accumulators[0] if self.accumulators else None
        )
        self.stack_depth = stack_depth
        self.lanes = tuple(lanes)
        self.min_idle_div = min_idle_div
        self.root_contrib = root_contrib
        self.param = int(param)

    def check_compiled(self) -> None:
        """Raise unless the CUDA engine can run this spec: a compiled
        family with its frame layout, one accumulator, and lanes that fit
        the engine's block."""
        rows, cols = self.lanes
        if self.name not in VECTOR_BODIES:
            raise ValueError(
                f"vector family {self.name!r} has no CUDA body: the engine "
                f"compiled into csrc/vector.cuh runs {VECTOR_BODIES} "
                "(user-defined bodies are ROADMAP A4)"
            )
        if (self.frame_words != _FRAME_WORDS[self.name]
                or len(self.accumulators) != 1):
            raise ValueError(f"{self.name} spec does not match its compiled "
                             "family's frame and accumulator")
        if rows * cols > MAX_LANES:
            raise ValueError(f"lanes {self.lanes}: the CUDA engine holds at "
                             f"most {MAX_LANES} lanes")


def _check_lanes(spec: VectorTaskSpec) -> None:
    rows, cols = spec.lanes
    if rows < 1 or cols < 2:
        raise ValueError(f"lanes {spec.lanes}: need rows >= 1 and cols >= 2 "
                         "(the steal rotation walks columns 1..cols-1)")
    if spec.stack_depth < 1 or spec.min_idle_div < 1:
        raise ValueError("stack_depth and min_idle_div must be >= 1")


def _select(stack: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """Per-lane read of a (S, ..., rows, cols) stack at level sp; 0 where
    sp is off the stack (JAX's select chain)."""
    S = stack.shape[0]
    idx = sp.clamp(0, S - 1).expand(stack.shape[1:]).unsqueeze(0)
    out = stack.gather(0, idx).squeeze(0)
    return torch.where((sp >= 0) & (sp < S), out, 0)


def _store(stack: torch.Tensor, lv: torch.Tensor, sp: torch.Tensor, value,
           mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask & (lv == sp), value, stack)


def _plane(x, like: torch.Tensor) -> torch.Tensor:
    """An accumulator contribution as an int32 plane (a missing one is 0)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full_like(like, int(x))


def _run_plain(spec: VectorTaskSpec, seed_frame, seed_count: int,
               max_steps: int) -> Tuple[int, Dict[str, int], bool, int]:
    """JAX's ``run`` over torch planes on the CPU: (nodes, accs, over,
    steps)."""
    _check_lanes(spec)
    S, U = spec.stack_depth, spec.frame_words
    rows, cols = spec.lanes
    nlanes = rows * cols
    min_idle = max(cols // 2, nlanes // spec.min_idle_div)
    i32 = torch.int32
    lanes = (rows, cols)
    zeros = torch.zeros(lanes, dtype=i32)
    lv = torch.arange(S, dtype=i32).view(S, 1, 1)
    fr = torch.zeros((S, U) + lanes, dtype=i32)
    ch = torch.zeros((S,) + lanes, dtype=i32)
    cn = torch.zeros((S,) + lanes, dtype=i32)
    seed_count = _i32(seed_count)
    for w in range(U):
        fr[0, w, 0, 0] = _i32(seed_frame[w])
    cn[0, 0, 0] = seed_count
    sp = torch.full(lanes, -1, dtype=i32)
    if seed_count > 0:
        sp[0, 0] = 0
    over = zeros.clone()
    nodes = zeros.clone()
    accs = [zeros.clone() for _ in spec.accumulators]

    def step():
        nonlocal sp, over, nodes, fr, ch, cn
        active = sp >= 0
        child = _select(ch, sp)
        count = _select(cn, sp)
        frame = tuple(_select(fr[:, w], sp) for w in range(U))
        expand = active & (child < count)
        cframe, ccount = spec.child(frame, child, torch)
        ccount = _plane(ccount, zeros)
        is_leaf = ccount == 0
        nodes = nodes + expand.to(i32)
        contribs = spec.contrib(cframe, ccount, torch)
        for i, name in enumerate(spec.accumulators):
            accs[i] = accs[i] + torch.where(
                expand, _plane(contribs.get(name, 0), zeros), 0)
        # Tail calls: the last non-leaf child replaces its parent's frame.
        last = expand & (child + 1 >= count)
        push = expand & ~is_leaf & ~last
        tail = expand & ~is_leaf & last
        pop = (expand & is_leaf & last) | (active & ~expand)
        ch = _store(ch, lv, sp, child + 1, expand & ~last)
        spp = sp + 1
        over = over | (push & (spp >= S)).to(i32)
        spp = torch.clamp_max(spp, S - 1)
        lvl = torch.where(push, spp, sp)
        newf = push | tail
        cf = torch.stack([_plane(c, zeros) for c in cframe])
        fr = torch.where((newf & (lv == lvl)).unsqueeze(1), cf, fr)
        ch = _store(ch, lv, lvl, 0, newf)
        cn = _store(cn, lv, lvl, ccount, newf)
        sp = torch.where(push, spp, torch.where(pop, sp - 1, sp))

    def balance(rnd: int):
        nonlocal sp, fr, ch, cn
        dc = 1 + rnd % (cols - 1)
        dr = (rnd // (cols - 1)) % rows

        def rot(x):
            return torch.roll(torch.roll(x, dc, -1), dr, -2)

        def unrot(x):
            return torch.roll(torch.roll(x, (rows - dr) % rows, -2),
                              (cols - dc) % cols, -1)

        donor = sp >= 1  # keeps its top frame, gives away level 0
        claim = (sp < 0) & (rot(donor.to(i32)) != 0)
        robbed = unrot(claim.to(i32)) != 0
        taken_fr, taken_ch, taken_cn = rot(fr[0]), rot(ch[0]), rot(cn[0])
        # Donors lose their bottom frame: level L takes level L + 1.
        fr = torch.where(robbed, torch.cat([fr[1:], fr[-1:]]), fr)
        ch = torch.where(robbed, torch.cat([ch[1:], ch[-1:]]), ch)
        cn = torch.where(robbed, torch.cat([cn[1:], cn[-1:]]), cn)
        sp = torch.where(robbed, sp - 1, sp)
        # Claimants install the stolen frame at level 0.
        fr[0] = torch.where(claim, taken_fr, fr[0])
        ch[0] = torch.where(claim, taken_ch, ch[0])
        cn[0] = torch.where(claim, taken_cn, cn[0])
        sp = torch.where(claim, 0, sp)

    def flags():
        """(any active, starved lanes, any donor): the loop conditions."""
        return (bool((sp >= 0).any()), int((sp < 0).sum()),
                bool((sp >= 1).any()))

    steps = rnd = 0
    active, ndone, donors = flags()
    while active and steps < max_steps:
        balance(rnd)
        # Do-while: one expansion step per balance round, then expand
        # refill-free until enough lanes starve (or none can donate).
        step()
        steps += 1
        active, ndone, donors = flags()
        while (active and (ndone < min_idle or not donors)
               and steps < max_steps):
            step()
            steps += 1
            active, ndone, donors = flags()
        rnd += 1
    accs_out = {name: _i32(int(accs[i].sum()))
                for i, name in enumerate(spec.accumulators)}
    return (_i32(int(nodes.sum())), accs_out,
            bool(over.any()) or steps >= max_steps, steps)


def make_subtree_runner(spec: VectorTaskSpec, max_steps: int = NO_LIMIT):
    """``run(seed_frame, seed_count) -> (nodes, acc_dict, overflow)``, the
    plain whole-subtree dispatch (JAX's ``make_subtree_runner``), on the
    CPU. ``nodes`` counts expanded tasks, not the seed (the scalar tier
    counts it); the results are Python ints and a bool."""

    def run(seed_frame, seed_count):
        return _run_plain(spec, seed_frame, seed_count, max_steps)[:3]

    return run


def subtree_run(spec: VectorTaskSpec, seed_frame, seed_count: int,
                max_steps: int = NO_LIMIT, device="cuda"):
    """One whole-subtree run: (nodes, acc_dict, over, steps). On the card
    the CUDA engine's standalone entry runs it (one block, counted in
    ``_build.LAUNCHES["vector"]``); on the CPU the plain version."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _run_plain(spec, seed_frame, seed_count, max_steps)
    spec.check_compiled()
    _check_lanes(spec)
    rows, cols = spec.lanes
    U, S = spec.frame_words, spec.stack_depth
    stack = torch.empty(S * (U + 2) * rows * cols, dtype=torch.int32,
                        device=dev)
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    words = [_i32(seed_frame[w]) for w in range(U)] + [0] * (3 - U)
    lib = _build.library("megakernel")
    fn = lib.hclib_vector_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3
    err = fn(VECTOR_BODIES.index(spec.name), rows, cols, S,
             spec.min_idle_div, spec.param, *words, _i32(seed_count),
             min(int(max_steps), NO_LIMIT), stack.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "vector engine")
    _build.LAUNCHES["vector"] += 1
    nodes, acc, over, steps = out.tolist()
    return nodes, {spec.accumulators[0]: acc}, bool(over), steps


# ----------------------------------------------------------------- fib

def fib_spec(max_n: int = 32, lanes: Tuple[int, int] = (8, 128),
             min_idle_div: int = 8) -> VectorTaskSpec:
    """fib as a vector-tier family: frame (n,), children n-1 and n-2,
    leaves (n < 2) contribute n. Task count = the recursion tree's node
    count, 2*fib(n+1) - 1."""

    def seed(args):
        n = args[0]
        return (n,), (2 if n >= 2 else 0)

    def child(frame, k, ops):
        c = frame[0] - 1 - k
        return (c,), (c >= 2).to(ops.int32) * 2

    def contrib(cframe, ccount, ops):
        return {"value": ops.where(ccount == 0, cframe[0], 0)}

    def root_contrib(args):
        return {"value": args[0]}

    return VectorTaskSpec(
        name="vfib", frame_words=1, seed=seed, child=child, contrib=contrib,
        accumulators=("value",), out_acc="value", stack_depth=max_n + 2,
        lanes=lanes, min_idle_div=min_idle_div, root_contrib=root_contrib,
    )


# ------------------------------------------------------------- n-queens

def _popcount(x, ops):
    """SWAR popcount over int32 planes (JAX's; int32 products wrap)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def nqueens_spec(n: int, lanes: Tuple[int, int] = (8, 128),
                 min_idle_div: int = 8) -> VectorTaskSpec:
    """N-queens as a vector-tier family: a frame is a partial placement as
    three bitboards (columns, left and right diagonal attacks); a task's
    children are the free columns of the next row, the k-th child the
    k-th set bit. Completed boards contribute one solution; the task count
    is the number of safe partial placements."""
    if not (1 <= n <= 16):
        raise ValueError("nqueens_spec wants 1 <= n <= 16")
    full = (1 << n) - 1

    def counts_of(cols, ld, rd, ops):
        free = ops.bitwise_not(cols | ld | rd) & full
        return ops.where(cols == full, 0, _popcount(free, ops))

    def seed(args):
        return (0, 0, 0), n

    def child(frame, k, ops):
        cols, ld, rd = frame
        free = ops.bitwise_not(cols | ld | rd) & full
        bit = ops.zeros_like(free)
        rank = ops.zeros_like(free)
        for b in range(n):
            m = (free >> b) & 1
            hit = (m == 1) & (rank == k)
            bit = ops.where(hit, 1 << b, bit)
            rank = rank + m
        ncols = cols | bit
        nld = ((ld | bit) << 1) & full
        nrd = (rd | bit) >> 1
        return (ncols, nld, nrd), counts_of(ncols, nld, nrd, ops)

    def contrib(cframe, ccount, ops):
        return {"solutions": (cframe[0] == full).to(ops.int32)}

    return VectorTaskSpec(
        name="vnqueens", frame_words=3, seed=seed, child=child,
        contrib=contrib, accumulators=("solutions",), out_acc="solutions",
        stack_depth=n + 2, lanes=lanes, min_idle_div=min_idle_div, param=n,
    )
