"""The one place that knows which machine the program runs on.

Kernels run compiled on the GPU and in the Pallas interpreter on the CPU,
where the tests run.  Any other platform is an error, never a silent
fallback: an interpreted kernel on an accelerator would hide the device.
"""

from __future__ import annotations

import jax

__all__ = ["platform", "kernel_interpret", "SUPPORTED"]

#: platforms the kernels know, and whether each interprets them
SUPPORTED = {"gpu": False, "cpu": True}


def platform() -> str:
    """JAX's default backend ("gpu" on an NVIDIA card, "cpu" in tests)."""
    return jax.default_backend()


def kernel_interpret(name: str | None = None) -> bool:
    """True when Pallas kernels must run in interpret mode (CPU only).
    Raises ``RuntimeError`` on a platform with no kernel route."""
    name = platform() if name is None else name
    if name not in SUPPORTED:
        raise RuntimeError(
            f"no kernel route for platform {name!r}; supported: "
            f"{sorted(SUPPORTED)}")
    return SUPPORTED[name]
