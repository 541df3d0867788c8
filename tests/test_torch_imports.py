"""The port stands alone: importing it pulls in no JAX and nothing of the
JAX package, and its entry points run on the card unless asked for the
CPU - on a machine without one they raise instead of falling back."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import hclib_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            hclib_tpu_torch.__path__, prefix="hclib_tpu_torch.")
    )


def test_imports_pull_in_no_jax():
    mods = _submodules()
    assert {"hclib_tpu_torch.device.megakernel",
            "hclib_tpu_torch.device.vector_engine",
            "hclib_tpu_torch.device.sw_pallas",
            "hclib_tpu_torch.device.forasync_tier",
            "hclib_tpu_torch.device.frontier",
            "hclib_tpu_torch.device.bnb",
            "hclib_tpu_torch.device.dyngraph",
            "hclib_tpu_torch.runtime.env",
            "hclib_tpu_torch.models.nqueens",
            "hclib_tpu_torch.models.fib",
            "hclib_tpu_torch.parallel.mesh",
            "hclib_tpu_torch.device.sharded",
            "hclib_tpu_torch.device.ici_steal",
            "hclib_tpu_torch.device.resident",
            "hclib_tpu_torch.device.pgas_kernel",
            "hclib_tpu_torch.device.stress"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'hclib_tpu.')) or k == 'hclib_tpu')))"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from jax" not in src
    assert "hclib_tpu." not in src.replace("hclib_tpu_torch", "")


ENTRY_POINTS = {
    "device_fib": lambda: __import__(
        "hclib_tpu_torch.device.workloads", fromlist=["x"]).device_fib(5),
    "device_uts_mk": lambda: __import__(
        "hclib_tpu_torch.device.workloads", fromlist=["x"]).device_uts_mk(),
    "device_cholesky": lambda: __import__(
        "hclib_tpu_torch.device.cholesky", fromlist=["x"]).device_cholesky(
            __import__("numpy").eye(128, dtype="float32")),
    "uts_fused": lambda: __import__(
        "hclib_tpu_torch.device.uts_fused", fromlist=["x"]).uts_fused(
            __import__("hclib_tpu_torch.models.uts", fromlist=["x"]).T3),
    "uts_vec": lambda: __import__(
        "hclib_tpu_torch.device.uts_vec", fromlist=["x"]).uts_vec(
            __import__("hclib_tpu_torch.models.uts", fromlist=["x"]).T3),
    "device_sw": lambda: __import__(
        "hclib_tpu_torch.device.smithwaterman", fromlist=["x"]).device_sw(
            __import__("numpy").zeros(128, "int32"),
            __import__("numpy").zeros(128, "int32")),
    "device_sw_wave": lambda: __import__(
        "hclib_tpu_torch.device.smithwaterman",
        fromlist=["x"]).device_sw_wave(
            __import__("numpy").zeros(128, "int32"),
            __import__("numpy").zeros(128, "int32")),
    "device_sw_batched": lambda: __import__(
        "hclib_tpu_torch.device.smithwaterman",
        fromlist=["x"]).device_sw_batched(
            __import__("numpy").zeros(128, "int32"),
            __import__("numpy").zeros(128, "int32")),
    "sw_scores": lambda: __import__(
        "hclib_tpu_torch.device.sw_vec", fromlist=["x"]).sw_scores(
            __import__("numpy").zeros((1, 8), "int32"),
            __import__("numpy").zeros((1, 8), "int32")),
    "device_vfib": lambda: __import__(
        "hclib_tpu_torch.device.workloads", fromlist=["x"]).device_vfib(10),
    "device_nqueens": lambda: __import__(
        "hclib_tpu_torch.device.workloads",
        fromlist=["x"]).device_nqueens(6),
    "subtree_run": lambda: (lambda ve: ve.subtree_run(
        ve.fib_spec(12), (10,), 2))(__import__(
            "hclib_tpu_torch.device.vector_engine", fromlist=["x"])),
    "sw_scores_pallas": lambda: __import__(
        "hclib_tpu_torch.device.sw_pallas", fromlist=["x"]).sw_scores_pallas(
            __import__("numpy").zeros((1, 8), "int32"),
            __import__("numpy").zeros((1, 8), "int32")),
    "run_forasync_device": lambda: (lambda fa, w: fa.run_forasync_device(
        *w.map_loop(2), dict(zip(("vin", "vout"), w.map_data(2)))))(
            __import__("hclib_tpu_torch.device.forasync_tier",
                       fromlist=["x"]),
            __import__("hclib_tpu_torch.device.workloads", fromlist=["x"])),
    "device_arrayadd": lambda: __import__(
        "hclib_tpu_torch.device.workloads",
        fromlist=["x"]).device_arrayadd(2),
    "run_frontier": lambda: (lambda f, w: f.run_frontier(
        "bfs", f.Graph(*w.rmat_edges(3, efactor=2, seed=1))))(
            __import__("hclib_tpu_torch.device.frontier", fromlist=["x"]),
            __import__("hclib_tpu_torch.device.workloads", fromlist=["x"])),
    "run_bnb": lambda: (lambda b: b.run_bnb(b.make_knapsack(4)))(
        __import__("hclib_tpu_torch.device.bnb", fromlist=["x"])),
    "run_dyngraph": lambda: (lambda d, w: d.run_dyngraph(
        "bfs", d.DynGraph(*w.rmat_edges(3, efactor=2, seed=1)),
        updates=[(0, 1)]))(
            __import__("hclib_tpu_torch.device.dyngraph", fromlist=["x"]),
            __import__("hclib_tpu_torch.device.workloads", fromlist=["x"])),
    "make_dyngraph_megakernel": lambda: (lambda d, w: d.make_dyngraph_megakernel(
        "sssp", d.DynGraph(*w.rmat_edges(3, efactor=2, seed=1))))(
            __import__("hclib_tpu_torch.device.dyngraph", fromlist=["x"]),
            __import__("hclib_tpu_torch.device.workloads", fromlist=["x"])),
    "Megakernel": lambda: __import__(
        "hclib_tpu_torch.device.megakernel", fromlist=["x"]).Megakernel(
            ["fib", "sum"]),
    "cuda_mesh": lambda: __import__(
        "hclib_tpu_torch.parallel.mesh", fromlist=["x"]).cuda_mesh(8),
    "CtaMesh": lambda: __import__(
        "hclib_tpu_torch.parallel.mesh", fromlist=["x"]).CtaMesh(
            (4, 2), ("x", "y")),
    "Megakernel_user_bodies": lambda: __import__(
        "hclib_tpu_torch.device.megakernel", fromlist=["x"]).Megakernel(
            ["fib", "sum", ("bump", lambda ctx: None,
                            "ctx.set_value(0, ctx.value(0) + ctx.arg(0));")]),
    "PGASMegakernel": lambda: __import__(
        "hclib_tpu_torch.device.pgas_kernel", fromlist=["x"]).PGASMegakernel(
            __import__("hclib_tpu_torch.device.megakernel",
                       fromlist=["x"]).Megakernel(
                [("nop", lambda ctx: None, "")], device="cpu"),
            __import__("hclib_tpu_torch.parallel.mesh",
                       fromlist=["x"]).CtaMesh((2,), ("q",))),
    "PGASMegakernel_ring": lambda: __import__(
        "hclib_tpu_torch.device.pgas_kernel", fromlist=["x"]).PGASMegakernel(
            __import__("hclib_tpu_torch.device.stress",
                       fromlist=["x"]).put_consume_megakernel(),
            __import__("hclib_tpu_torch.parallel.mesh",
                       fromlist=["x"]).cuda_mesh(3),
            channels={"c0": ("heap", 1)}),
    "forest_steal": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).forest_steal(
            ndev=2, roots=2, n=3, capacity=64),
    "unified_load": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).unified_load(
            ndev=2, n=4, fadds=2, capacity=64),
    "dryrun0": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).dryrun0(),
    "compose_inject": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).compose_inject(),
    "five_way": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).five_way(),
    "volume": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).volume(),
    "inject_forest": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).inject_forest(
            ndev=2, roots=2, n=3, per_dev=2, n_inj=2, capacity=64),
    "tenant_mesh": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).tenant_mesh(
            ndev=2, lanes=(("a", 1, 2), ("late", 1, 1))),
    "ResidentKernel_inject": lambda: __import__(
        "hclib_tpu_torch.device.resident", fromlist=["x"]).ResidentKernel(
            __import__("hclib_tpu_torch.device.workloads",
                       fromlist=["x"]).make_fib_megakernel(64),
            __import__("hclib_tpu_torch.parallel.mesh",
                       fromlist=["x"]).CtaMesh((2,), ("q",)),
            inject=True, tenants=2),
    "uts_fault": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).uts_fault(
            ndev=2, max_depth=4),
    "forest_fault": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).forest_fault(
            ndev=2, roots=2, n=3, capacity=64),
    "fault_run": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).fault_run("dead"),
    "uts_ckpt": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).uts_ckpt(
            ndev=2, max_depth=4),
    "ckpt_uts_resident": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).ckpt_uts_resident(2),
    "ckpt_waits_resident": lambda: __import__(
        "hclib_tpu_torch.device.stress",
        fromlist=["x"]).ckpt_waits_resident(),
    "inject_forest_quiesced": lambda: __import__(
        "hclib_tpu_torch.device.stress", fromlist=["x"]).inject_forest(
            ndev=2, roots=2, n=3, per_dev=2, n_inj=2, capacity=64,
            quiesce=True),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()


def test_build_needs_nvcc_and_says_so(monkeypatch, tmp_path):
    """Without nvcc the build raises (there is no fallback path)."""
    from hclib_tpu_torch import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
