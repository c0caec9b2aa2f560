"""Hand-written Hopper kernels of the port, one package per TPU kernel
they replace, each with its plain PyTorch version (`ref.py`) and a
wrapper (`ops.py`).  A wrapper picks by the device of its tensors: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (or
raises) — there is no fallback from one to the other.

The one exception is the dry run (`launch.dryrun`), which traces a
rank's step on fake tensors that hold no memory: there (`shape_only`) a
wrapper launches nothing and runs no plain version, but returns outputs
of the right shape and dtype and records its kernel's work, the FLOPs
and bytes of the formula its bound uses (`record_work`)."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMS: Dict[int, int] = {}

# the dry run's recorder, fn(kernel name, flops, bytes); None outside one
DRY_RUN = None


def shape_only(*tensors: torch.Tensor) -> bool:
    """Is this call traced by the dry run on its fake tensors?"""
    if DRY_RUN is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors)


def record_work(name: str, flops: float, nbytes: float) -> None:
    """Add a shape-only call's kernel work to the dry run's counts."""
    DRY_RUN(name, float(flops), float(nbytes))


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check_cuda_operand(name: str, t: torch.Tensor, dtypes=None) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {tuple(dtypes)}")


def as_operand(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`x` (a tensor, array or sequence) as a contiguous tensor of `dtype`
    on `device`; a tensor that already is one is returned as it is."""
    if (isinstance(x, torch.Tensor) and x.dtype == dtype and x.device == device
            and x.is_contiguous()):
        return x
    return torch.as_tensor(x, device=device).to(dtype).contiguous()


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} dtype {t.dtype}: the kernels take float32 or bfloat16")
    return DTYPE_CODES[t.dtype]


def ptr(t) -> Optional[int]:
    """The address of a tensor's data as a ctypes pointer argument (None for
    NULL)."""
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor):
    """A context that makes `t`'s device current for a launch (nothing to
    do, the common case, when it already is)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (read once)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n
