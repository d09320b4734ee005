"""Device introspection (counterpart: seld_tpu/utils/platform.py).

It only reads: no backend switch (cuDNN autotuning, TF32) is set here.
"""

from __future__ import annotations

import torch


def _describe(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    return (f"cuda:{index} {props.name} sm_{props.major}{props.minor} "
            f"{props.total_memory / 2**30:.1f} GiB")


def describe_devices(device: torch.device, logger=None) -> dict:
    """A summary of the devices of `device`'s type, with the JAX package's
    keys: `platform` ("gpu" for CUDA, as JAX names it, else "cpu"),
    `device_count`, `devices` (one string each: name, compute capability
    and memory on CUDA) and `default_backend`."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        info = {"platform": "gpu", "device_count": count,
                "devices": [_describe(i) for i in range(count)], "default_backend": "gpu"}
    else:
        info = {"platform": "cpu", "device_count": 1,
                "devices": [f"cpu ({torch.get_num_threads()} threads)"],
                "default_backend": "cpu"}
    if logger is not None:
        logger.info("torch backend: %s | %d device(s): %s", info["default_backend"],
                    info["device_count"], ", ".join(info["devices"]))
    return info
