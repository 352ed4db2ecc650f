"""Device resolution and the one kernel-routing rule.

* Every public entry point of the port takes ``device=None``, and
  ``None`` means ``"cuda"``.  On a machine without a card that raises:
  the port never moves to the CPU on its own.  Tests pass
  ``device="cpu"``.
* A kernel wrapper launches its CUDA kernel for tensors on a CUDA device
  and runs the kernel's plain PyTorch version for tensors on the CPU,
  and for tensors on the ``meta`` device, which hold shapes only and
  compute nothing (the dry-run counts a step's FLOPs on them).  Nothing
  else selects between the two: there is no fallback from the kernel to
  the plain version and no switch that forces the plain version on the
  card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch route")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they all lie on the CPU or all on ``meta`` (run the plain
    version).  Mixed or other devices raise.  (Tensor flags, not
    ``device`` objects: the wrappers' host time is part of every
    call.)"""
    cuda = cpu = 0
    for t in tensors:
        cuda += t.is_cuda
        cpu += t.is_cpu
    if cuda == len(tensors):
        return True
    if cpu == len(tensors) or all(t.is_meta for t in tensors):
        return False
    raise ValueError(f"kernel inputs must all lie on one CUDA device or "
                     f"all on the CPU, got "
                     f"{sorted({t.device.type for t in tensors})}")


def check_inputs(shapes: dict) -> None:
    """Raise unless every ``label: (tensor, shape)`` entry is an int32,
    contiguous tensor of that shape: what a kernel's pointers assume."""
    for label, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.int32:
            raise TypeError(f"{label} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")


_SMS: dict = {}


def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once (the input of the
    kernels' launch plans)."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


#: the float types the model kernels read, by their C-side code
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def float_code(*tensors: torch.Tensor) -> int:
    """The C-side type code of a model kernel's float inputs, which must
    share one type of :data:`FLOAT_CODES` and be contiguous; raises
    otherwise."""
    dtype = tensors[0].dtype
    code = FLOAT_CODES.get(dtype)
    for t in tensors:
        if code is None or t.dtype != dtype:
            raise TypeError(f"kernel inputs must share one type of float32 "
                            f"or bfloat16, got "
                            f"{sorted({str(u.dtype) for u in tensors})}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return code


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the backward kernels read
    their gradients (one may arrive as a view at an odd offset)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def launch(name: str, index: int, *args) -> None:
    """Launches kernel ``name`` (its C entry in ``build.KERNELS``) with
    ``args`` and the current stream of CUDA device ``index``, on that
    device; raises if the launch failed.  Makes the device current only
    when it is not already (the wrappers' host time is part of every
    call)."""
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return launch(name, index, *args)
    err = build.kernel(name)(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
