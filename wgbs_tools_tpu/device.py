"""Where device work runs: the one placement decision of the package.

With a GPU, the pat2beta pileup and bam2pat calling run on the card by
default; exact segmentation (WGBS_TPU_SEGMENT_EXACT_DEVICE=1) and the
multi-card pileup (`pat2beta --sharded`) run there when asked for, being
no faster on an H100 host. A device failure raises. Without a GPU, the
host C++ paths run. Callers ask `has_gpu()`; tests mock `platform()`.
"""

import subprocess
import sys

import jax


def platform():
    """JAX's default platform name ("gpu", "cpu")."""
    return jax.devices()[0].platform


def has_gpu():
    """True when JAX's default device is a GPU."""
    return platform() == "gpu"


def card_lines():
    """`name, power.limit` of each card as nvidia-smi reports them (read by
    a child process that stays off JAX); empty without nvidia-smi."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [l.strip() for l in r.stdout.splitlines() if l.strip()]


def require_gpu(what):
    """For measurement scripts: exit non-zero unless JAX's default device
    is a GPU (a CPU number is never reported as a device number); else
    print the device and each card's name and power limit."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"{what}: JAX found no GPU (platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(1)
    print(f"[{what}] device: {devs[0].device_kind} x{len(devs)}, "
          f"jax {jax.__version__}; card: " + " | ".join(card_lines()),
          flush=True)
    return devs
