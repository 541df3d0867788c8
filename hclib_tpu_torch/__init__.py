"""hclib-tpu ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package ``hclib_tpu`` is the reference; this package mirrors its
layout (``device/``, ``ops/``, ``models/``, ``runtime/``) and imports
nothing of it, and no JAX. Every entry point takes ``device=`` and runs on
the card (``"cuda"``) unless the caller asks for ``"cpu"``, where each
kernel's plain PyTorch version runs instead. Kernels are CUDA C++ under
``csrc/``, built by ``_build.py`` on first use.

Entry points: ``device.workloads.device_fib``,
``device.workloads.device_uts_mk``, ``device.cholesky.device_cholesky``
and ``device.smithwaterman.device_sw`` / ``device_sw_wave`` /
``device_sw_batched``, all through ``device.megakernel.Megakernel.run``
(scalar and batch tiers); ``device.sw_vec.sw_scores`` (torch ops); and
the canonical UTS engines ``device.uts_fused.uts_fused`` (CUDA) and
``device.uts_vec.uts_vec`` (its plain lockstep version); the forasync
tier ``device.forasync_tier.run_forasync_device`` and
``device.workloads.device_arrayadd``.
"""

from .runtime.resilience import DeviceFaultPlan, StallError

__all__ = ["DeviceFaultPlan", "StallError"]
