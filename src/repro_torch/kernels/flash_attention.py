"""Hopper kernel for the forward partial flash attention, bound through ctypes.

The kernel (csrc/flash_partial.cu) replaces the Pallas TPU kernel
``_flash_partial_kernel`` / ``_fwd_impl`` of ``repro/kernels/flash_attention.py``
and returns the same un-normalized ``(o, m, l)`` triple as
``kernels/ref.py::attention_partial_ref``, its plain version.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file (one shared library per source content, with the
``-Xptxas -v`` report kept next to it) and loaded with ``ctypes``.  Nothing is
compiled or loaded at import, so the module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).parent / "csrc" / "flash_partial.cu"
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Calls of flash_attention_partial that launched the kernel: one per call.
# A call that splits the KV range launches the merge kernel as well, and
# merge_launches counts those.
launches = 0
merge_launches = 0

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the flash-attention "
                           "kernel needs the CUDA toolkit")
    return path


def build() -> tuple:
    """Compile the kernel unless this source was already built; returns
    ``(library path, nvcc's register / shared-memory report)``."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libflash_partial_{tag}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so, log.read_text() if log.exists() else ""


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_partial_fwd.argtypes = (
            [i32] + [ptr] * 12 + [i32] * 13 + [i64] * 9
            + [ctypes.c_float, i32, ptr])
        lib.flash_partial_fwd.restype = i32
        _lib = lib
    return _lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 128        # largest hd_k / hd_v the kernel takes (csrc kMaxHd)
MAX_ROWS = 64       # query rows per block: G heads x bq tokens (16 x 4 row groups)
MAX_SPLITS = 32     # KV splits the merge takes (csrc kMaxSplits)
BLOCK_K = 64        # KV slots per tile (csrc kBlockK)


def _geometry(B: int, Tq: int, S: int, G: int, Hkv: int, n_sm: int):
    """Launch geometry: (row_groups, bq, nsplit, tiles_per_split).

    A block holds 16 x row_groups query rows, the fewest that fit G x Tq
    (decode: 16 rows for G = 7), so bq = 16 x row_groups // G tokens.  When
    (query tiles x KV heads x batch) blocks would leave the card's SMs idle,
    the KV range is split over more blocks, about two per SM, and the
    partials merged (flash-decoding); prefill chunks fill the card unsplit.
    """
    rows = G * Tq
    row_groups = 1 if rows <= 16 else 2 if rows <= 32 else 4
    bq = min(Tq, 16 * row_groups // G)
    blocks = -(-Tq // bq) * Hkv * B
    n_tiles = max(1, -(-S // BLOCK_K))
    per_split = n_tiles
    if blocks < n_sm:
        want = min(MAX_SPLITS, n_tiles, -(-2 * n_sm // blocks))
        per_split = -(-n_tiles // want)
    return row_groups, bq, -(-n_tiles // per_split), per_split


def _check_vec(name: str, t, hd: int):
    """The kernel loads K and V in 16-byte vectors: the base, the strides and
    the head dim must be whole vectors."""
    epv = 16 // t.element_size()
    if t.data_ptr() % 16 or hd % epv or any(st % epv for st in t.stride()[:3]):
        raise ValueError(
            f"{name} must be 16-byte aligned with head dim and strides that are "
            f"multiples of {epv} {t.dtype} elements; got head dim {hd}, "
            f"strides {t.stride()}, address {t.data_ptr():#x}")


def _positions(x, B: int, Tq: int, device, name: str):
    """[Tq] or [B, Tq] integer positions -> (contiguous int32, batch stride);
    a [Tq] row is shared by the batch (stride 0), not copied per row."""
    if x.device != device or x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} must be an integer tensor on {device}")
    if tuple(x.shape) not in ((Tq,), (B, Tq)):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"[{Tq}] or [{B}, {Tq}]")
    return x.to(torch.int32).contiguous(), (Tq if x.dim() == 2 else 0)


def flash_attention_partial(q, k, v, q_pos, kv_pos, *, causal=True,
                            scale=None, q_start=None):
    """Partial flash attention on the card.

    q: [B, Tq, H, hd_k]; k: [B, S, Hkv, hd_k]; v: [B, S, Hkv, hd_v], all
    float32 or all bfloat16 on one CUDA device, last dim contiguous (other
    strides are free: K and V may be views of a larger cache, 16-byte
    aligned, with head dims and strides of whole 16-byte vectors);
    q_pos and q_start: [Tq] or [B, Tq] int; kv_pos: [S] int (2**30 = empty).
    Returns (o [B,Tq,H,hd_v] f32 un-normalized, m [B,Tq,H] f32, l [B,Tq,H] f32).
    """
    global launches, merge_launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention_partial takes CUDA tensors; the "
                         "plain version is kernels/ref.py")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, T, heads, head_dim]")
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape[0] != B or k.shape[-1] != hdk or tuple(v.shape[:3]) != (B, S, Hkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B == 0 or Tq == 0 or Hkv == 0 or H % Hkv:
        raise ValueError(f"need B, Tq >= 1 and H % Hkv == 0 (B={B}, Tq={Tq}, "
                         f"H={H}, Hkv={Hkv})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    G = H // Hkv
    if G > MAX_ROWS or hdk > MAX_HD or hdv > MAX_HD:
        raise ValueError(f"kernel takes G <= {MAX_ROWS} and head dims <= "
                         f"{MAX_HD}; got G={G}, hd_k={hdk}, hd_v={hdv}")
    _check_vec("k", k, hdk)
    _check_vec("v", v, hdv)
    if kv_pos.device != dev or kv_pos.dim() != 1 or kv_pos.shape[0] != S:
        raise ValueError(f"kv_pos must be [{S}] on {dev}")
    kv_pos = kv_pos.to(torch.int32).contiguous()
    q_pos, qpos_sb = _positions(q_pos, B, Tq, dev, "q_pos")
    q_start, qstart_sb = ((None, 0) if q_start is None
                          else _positions(q_start, B, Tq, dev, "q_start"))
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)

    lib = _load()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    row_groups, bq, nsplit, per_split = _geometry(B, Tq, S, G, Hkv, n_sm)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    o, m, l = out(B, Tq, H, hdv), out(B, Tq, H), out(B, Tq, H)
    parts = ((out(nsplit, B, Tq, H, hdv), out(nsplit, B, Tq, H),
              out(nsplit, B, Tq, H)) if nsplit > 1 else ())
    with torch.cuda.device(dev):
        rc = lib.flash_partial_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(),
            None if q_start is None else q_start.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *([t.data_ptr() for t in parts] or [None] * 3),
            B, Tq, S, H, Hkv, hdk, hdv, row_groups, bq, nsplit, per_split,
            qpos_sb, qstart_sb,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_partial_fwd launch failed: CUDA error {rc}")
    launches += 1
    merge_launches += int(nsplit > 1)
    return o, m, l
