"""The accelerator a measurement runs on.

Every timing this repo prints names its device: JAX's platform, kind and
count, and the card's name and power limit as ``nvidia-smi`` reports them
(a card set below its maximum power runs slower under load).  A
measurement that finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys

import jax

#: Published dense peaks per ``device_kind`` (NVIDIA H100 SXM data sheet,
#: without sparsity; they assume the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks() -> dict:
    """Peak rates of the first device's kind; a device that is not in
    :data:`PEAKS` is an error, never a default."""
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=30,
        check=True,
    ).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def describe() -> dict:
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu(count: int = 1) -> dict:
    """Exit non-zero unless JAX sees at least ``count`` GPUs."""
    dev = describe()
    if dev["platform"] != "gpu" or dev["count"] < count:
        print(
            f"needs {count} GPU(s); JAX found {dev['count']} "
            f"{dev['platform']} device(s)",
            file=sys.stderr,
        )
        sys.exit(2)
    return dev
