"""Build / system metadata — the reference's buildinfo + sysInfo modules
(src/common/version_build_info.cc, src/common/sysinfo.cc), re-targeted at
the JAX runtime: compiler/flags become Python/jax/jaxlib versions, the
thread autodetect becomes the XLA device inventory, and the git metadata
is read from the working tree when available.

`get_params()` mirrors buildinfo::getAllBuildInfoVector()'s key/value
list and is what the logger badge / render-info string consumes.
"""
from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Dict, List, Tuple

from .. import __version__

_VER = tuple(int(x) for x in __version__.split(".")[:3])


def get_version_string() -> str:
    git = get_git_commit()
    return __version__ + (f"+g{git[:8]}" if git else "")


def get_version_major() -> int:
    return _VER[0]


def get_version_minor() -> int:
    return _VER[1]


def get_version_patch() -> int:
    return _VER[2]


def get_git_commit() -> str:
    """Working-tree commit hash, empty outside a git checkout (the
    reference bakes this in at configure time; a source-run library can
    read it live)."""
    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def get_architecture() -> str:
    return platform.machine()


def get_operating_system() -> str:
    return f"{platform.system()} {platform.release()}"


def get_compiler() -> str:
    """The 'compiler' of this framework is the Python/XLA stack."""
    import jax
    import jaxlib
    return (f"python {sys.version.split()[0]}, jax {jax.__version__}, "
            f"jaxlib {jaxlib.__version__}")


def get_devices() -> List[str]:
    """XLA device inventory — the thread-count analogue
    (sysinfo::getNumSystemThreads)."""
    import jax
    try:
        return [f"{d.platform}:{d.id} {d.device_kind}"
                for d in jax.devices()]
    except Exception:
        return []


def get_num_devices() -> int:
    return len(get_devices())


def gpu_name_and_power_limit() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Raises when nvidia-smi
    is missing or fails: a timing without its card is not reported."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record() -> Dict[str, object]:
    """What every measurement names: JAX's platform, device kind and
    device count, and the card's name and power limit."""
    import jax
    devs = jax.devices()
    rec: Dict[str, object] = {"platform": devs[0].platform,
                              "kind": devs[0].device_kind,
                              "count": len(devs)}
    if rec["platform"] == "gpu":
        rec["card"] = gpu_name_and_power_limit()
    return rec


def get_ram_gb() -> float:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return round(pages * page_size / 2 ** 30, 1)
    except (ValueError, OSError):
        return 0.0


def get_params() -> Dict[str, str]:
    """Key/value build+system table (getAllBuildInfoVector analogue)."""
    return {
        "version": get_version_string(),
        "version_major": str(get_version_major()),
        "version_minor": str(get_version_minor()),
        "version_patch": str(get_version_patch()),
        "git_commit": get_git_commit(),
        "architecture": get_architecture(),
        "operating_system": get_operating_system(),
        "compiler": get_compiler(),
        "num_devices": str(get_num_devices()),
        "ram_gb": str(get_ram_gb()),
    }


def sysinfo_string() -> str:
    """One-line render-info summary (Scene render-settings string
    analogue, scene.cc:155)."""
    devs = get_devices()
    dev = devs[0] if devs else "no-device"
    return (f"libyafaray_tpu {get_version_string()} | {dev} x"
            f"{len(devs)} | {get_operating_system()} "
            f"{get_architecture()} | {get_compiler()}")
