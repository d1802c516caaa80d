"""Launching the port's CUDA kernels, and what their wrappers share.

Each kernel is a C entry ``<name>_<bf16|f32>`` of a library built from
``csrc/<library>.cu`` (``ops/build.py``), called through ``ctypes`` on the
current stream of the operands' device.  ``LAUNCHES`` counts, per kernel,
the wrapper calls that launched it (a call that runs several CUDA launches
counts once), and nothing else increments it.  ``BODIES`` counts, per
kernel whose C entry reports which of its bodies it launched, those same
launches by body.  The operand checks are the
ones every wrapper runs before it picks the plain version (CPU tensors) or
the kernel (CUDA tensors).
"""

from __future__ import annotations

import ctypes

import torch

from nerf_tpu_torch.device import check_device
from nerf_tpu_torch.ops import build

PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
U64P, INTP = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int)

# kernel name -> (library, C argument types without the trailing stream)
SIGNATURES: dict[str, tuple[str, list]] = {}
LAUNCHES: dict[str, int] = {}
# kernel name -> {body name: launches}, for the entries that report a body
BODIES: dict[str, dict[str, int]] = {}


def register(signatures: dict) -> None:
    """Add kernels ``{name: (library, argtypes)}`` and their counts."""
    SIGNATURES.update(signatures)
    for name in signatures:
        LAUNCHES.setdefault(name, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BODIES.clear()


def count_body(fn_name: str, body: str) -> None:
    """Count a launch of ``fn_name`` that its C entry reported as ``body``
    (called by the wrapper right after ``launch``)."""
    per = BODIES.setdefault(fn_name, {})
    per[body] = per.get(body, 0) + 1


def launch(fn_name: str, dtype, device, *args) -> None:
    """Call the C entry ``<fn_name>_<bf16|f32>`` on ``device``'s current
    stream (the last argument) and raise if it reports a CUDA error."""
    lib_name, argtypes = SIGNATURES[fn_name]
    lib = build.load(lib_name)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{fn_name}_{suffix}")
    err_fn = getattr(lib, f"{lib_name}_error_string")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes + [PTR]
        err_fn.restype = ctypes.c_char_p
        err_fn.argtypes = [ctypes.c_int]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = err_fn(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")
    LAUNCHES[fn_name] += 1


def pointers(ts):
    """The device pointers of ``ts`` as a C array of uint64."""
    return (ctypes.c_uint64 * len(ts))(*[t.data_ptr() for t in ts])


def prep_weights(ws, biases, cd: torch.dtype):
    """Kernel operands of a weight tuple: matrices in ``cd``, the entries at
    ``biases`` in f32, all contiguous."""
    return tuple(w.to(torch.float32 if i in biases else cd).contiguous()
                 for i, w in enumerate(ws))


def check_operands(ws, encs, n_ws: int, biases, dev: torch.device):
    """Validate what the kernels take: 2-D contiguous f32/bf16 inputs of one
    dtype and row count, (in, out) matrices in that dtype and (1, W) f32
    biases, all on ``dev``."""
    if len(ws) != n_ws:
        raise ValueError(f"expected {n_ws} weights, got {len(ws)}")
    cd = encs[0].dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {cd}")
    for i, e in enumerate(encs):
        check_device(e, dev, f"encoding {i}")
        if e.dim() != 2 or e.dtype != cd or not e.is_contiguous():
            raise ValueError(f"encoding {i} must be a contiguous 2-D {cd} "
                             f"tensor, got {tuple(e.shape)} {e.dtype}")
        if e.shape[0] != encs[0].shape[0]:
            raise ValueError("encodings differ in row count")
    check_weights(ws, biases, cd, dev)


def check_weights(ws, biases, cd, dev: torch.device):
    """Raise unless every entry of ``ws`` is a contiguous 2-D tensor on
    ``dev``, f32 at ``biases`` and ``cd`` elsewhere."""
    for i, w in enumerate(ws):
        check_device(w, dev, f"weight {i}")
        if w.dim() != 2 or not w.is_contiguous():
            raise ValueError(f"weight {i} must be a contiguous 2-D tensor")
        want = torch.float32 if i in biases else cd
        if w.dtype != want:
            raise ValueError(f"weight {i} must be {want}, got {w.dtype}")


def check_tensor(t, shape, dtype, dev, name: str):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``."""
    check_device(t, dev, name)
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {tuple(t.shape)} "
                         f"{t.dtype}")


def check_shapes(ws, pairs, biases):
    """Check that each (index, expected shape) pair holds, and that each
    bias at ``biases`` is (1, width of the matrix before it)."""
    pairs = list(pairs) + [(i, (1, ws[i - 1].shape[1])) for i in biases]
    for i, want in pairs:
        if tuple(ws[i].shape) != tuple(want):
            raise ValueError(f"weight {i} has shape {tuple(ws[i].shape)}, "
                             f"expected {tuple(want)}")
