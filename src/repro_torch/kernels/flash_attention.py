"""Hopper kernels for the partial flash attention, bound through ctypes.

Four CUDA sources replace the three Pallas TPU kernels of
``repro/kernels/flash_attention.py``:

- ``csrc/flash_partial_tc.cu``: the forward ``_flash_partial_kernel`` /
  ``_fwd_impl`` on the tensor cores, for bf16 inputs, returning the
  un-normalized ``(o, m, l)`` triple of ``kernels/ref.py::attention_partial_ref``,
  its plain version; p is split into three bf16 terms, and a decode call
  whose KV range is split merges the partials inside the same launch;
- ``csrc/flash_partial.cu``: the same forward in fp32 on the CUDA cores, for
  fp32 inputs, with a second kernel that merges a split KV range;
- ``csrc/flash_partial_bwd_tc.cu``: the backward ``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel`` (``_bwd_impl``) on the tensor cores, for
  bf16 inputs, with every fp32 operand split into three bf16 terms;
- ``csrc/flash_partial_bwd.cu``: the same two kernels in fp32 on the CUDA
  cores, for fp32 inputs.

Each tensor-core source has a narrow kernel (head dims up to 128) and a wide
one for MLA's heads (hd_k up to 576, hd_v up to 512, G up to 128:
deepseek-v3's q_eff against its latent, v the latent's first 512 columns),
entry points ``*_tc`` and ``*_tc_wide``; the wrappers pick by head dim and
count both as the same kernel.  The CUDA-core pair takes head dims up to 128
and G up to 64 and raises above.  ``csrc/tc_common.cuh`` holds what the
tensor-core sources share (fragment layout, the split, the visible-tile
decision).  Both forwards are held to
their plain version at 1e-5; both backward pairs have the plain version
``kernels/ref.py::attention_partial_bwd_ref`` and are held to it at 1e-5 x
max |plain gradient|.  ``flash_attention_partial`` and
``flash_attention_partial_bwd`` pick their kernels by dtype (bf16: tensor
cores, fp32: CUDA cores) and raise on what a kernel does not take; their
``kernels=`` argument, for measurement only, runs the CUDA-core kernels on
bf16 inputs.

``FlashPartial`` ties them together as the counterpart of the reference's
``custom_vjp`` (``_flash_partial`` / ``_fwd`` / ``_bwd``).

Each source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file (one shared library per content of the source
and the headers, with the ``-Xptxas -v`` report kept next to it; sources not
yet built are compiled in parallel) and loaded with ``ctypes``.  Nothing is
compiled or loaded at import, so the module imports on a machine without
CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import ref as _ref

_CSRC = Path(__file__).parent / "csrc"
SOURCES = {"fwd": _CSRC / "flash_partial.cu", "fwd_tc": _CSRC / "flash_partial_tc.cu",
           "bwd": _CSRC / "flash_partial_bwd.cu", "bwd_tc": _CSRC / "flash_partial_bwd_tc.cu"}
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel, counted by the wrappers where they launch it:
# ``launches`` the CUDA-core forward, ``merge_launches`` its split-KV merge
# kernel, ``fwd_tc_launches`` the tensor-core forward (one per call) and
# ``merged_in_kernel`` its calls that split the KV range and merged the
# partials in the same launch, ``bwd_dq_launches`` and ``bwd_dkv_launches``
# the two fp32 CUDA-core backward kernels, ``bwd_dq_tc_launches`` and
# ``bwd_dkv_tc_launches`` the two tensor-core ones.
launches = 0
merge_launches = 0
fwd_tc_launches = 0
merged_in_kernel = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
bwd_dq_tc_launches = 0
bwd_dkv_tc_launches = 0

_libs = {}
_tickets = {}  # device -> the tensor-core forward's split counters


def reset_counts():
    global launches, merge_launches, fwd_tc_launches, merged_in_kernel
    global bwd_dq_launches, bwd_dkv_launches, bwd_dq_tc_launches, bwd_dkv_tc_launches
    launches = merge_launches = fwd_tc_launches = merged_in_kernel = 0
    bwd_dq_launches = bwd_dkv_launches = bwd_dq_tc_launches = bwd_dkv_tc_launches = 0


def counts() -> dict:
    return {"fwd": launches, "merge": merge_launches, "fwd_tc": fwd_tc_launches,
            "merged_in_kernel": merged_in_kernel, "bwd_dq": bwd_dq_launches,
            "bwd_dkv": bwd_dkv_launches, "bwd_dq_tc": bwd_dq_tc_launches,
            "bwd_dkv_tc": bwd_dkv_tc_launches}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the flash-attention "
                           "kernels needs the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    """The library built from ``src``, named by the content of the source,
    of the headers beside it and of the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{src.stem}_{tag}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named sources unless this content was already built, all
    nvcc processes started together; returns ``{name: (library path,
    nvcc's register / shared-memory report)}``."""
    jobs = {}
    for name in names:
        src, so = SOURCES[name], _target(SOURCES[name])
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            jobs[name] = (tmp, so, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (tmp, so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name].name} "
                               f"({proc.returncode}):\n{out}")
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    result = {}
    for name in names:
        so = _target(SOURCES[name])
        log = so.with_suffix(".log")
        result[name] = (so, log.read_text() if log.exists() else "")
    return result


def _bind(name: str, path) -> ctypes.CDLL:
    """Load the shared library built from source ``name`` at ``path`` and
    declare its entry points' C signatures (the tensor-core sources have a
    narrow and a wide one)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries = {"fwd": {"flash_partial_fwd": ([i32], 12, 13)},
               "fwd_tc": {"flash_partial_fwd_tc": ([], 13, 13),
                          "flash_partial_fwd_tc_wide": ([], 13, 11)},
               "bwd": {"flash_partial_bwd": ([i32, i32], 12, 11)},
               "bwd_tc": {"flash_partial_bwd_tc": ([i32], 15, 10),
                          "flash_partial_bwd_tc_wide": ([i32], 15, 9)}}[name]
    for entry, (head, n_ptr, n_int) in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = head + [ptr] * n_ptr + [i32] * n_int + [i64] * 9 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
    return lib


def _load(name: str):
    if name not in _libs:
        _libs[name] = _bind(name, build((name,))[name][0])
    return _libs[name]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 128        # largest hd_k / hd_v of the CUDA-core and narrow tensor-core kernels (csrc kMaxHd)
WIDE_HD_K = 576     # largest hd_k of the wide tensor-core kernels (csrc kWideHdK): MLA's q_eff
WIDE_HD_V = 512     # largest hd_v of the wide ones (csrc kWideHdV): MLA's latent values
MAX_G_TC = 128      # most grouped heads a tensor-core call takes (one token's a 128-row block)
MAX_ROWS = 64       # query rows per CUDA-core forward block: G heads x bq tokens (16 x 4 row groups)
WIDE_ROWS = 32      # fold rows (token x grouped head) of a wide block (csrc kWideRows)
WIDE_BLOCK_K = 32   # KV slots per wide tile (csrc kWideBlockK)
MAX_SPLITS = 32     # KV splits the merges take (csrc kMaxSplits)
BLOCK_K = 64        # KV slots per tile (csrc kBlockK)
TC_DQ_ROWS = 128    # query rows of a tensor-core dq block (csrc kDqRows)
TC_FWD_WARPS = 8    # most warps of a tensor-core forward block, 16 query rows each (csrc kMaxWarps)
SPLIT_TERMS = 3     # bf16 terms of a split fp32 operand (csrc kTerms)
KERNELS = ("tensor_cores", "cuda_cores")


def _rows(Tq: int, G: int):
    """(row_groups, bq): a block holds 16 x row_groups query rows, the fewest
    that fit G x Tq (decode: 16 rows for G = 7), so bq = 16 x row_groups // G
    tokens."""
    rows = G * Tq
    row_groups = 1 if rows <= 16 else 2 if rows <= 32 else 4
    return row_groups, min(Tq, 16 * row_groups // G)


def _splits(blocks: int, n_tiles: int, n_sm: int):
    """(nsplit, tiles_per_split): about two blocks per SM by splitting the KV
    range of ``blocks`` blocks (flash-decoding), no split empty."""
    want = min(MAX_SPLITS, n_tiles, -(-2 * n_sm // blocks))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split


def _geometry(B: int, Tq: int, S: int, G: int, Hkv: int, n_sm: int):
    """CUDA-core forward launch geometry: (row_groups, bq, nsplit,
    tiles_per_split).

    Query tiles as ``_rows``.  When
    (query tiles x KV heads x batch) blocks would leave the card's SMs idle,
    the KV range is split over more blocks, about two per SM, and the
    partials merged (flash-decoding); prefill chunks fill the card unsplit.
    """
    row_groups, bq = _rows(Tq, G)
    blocks = -(-Tq // bq) * Hkv * B
    n_tiles = max(1, -(-S // BLOCK_K))
    if blocks < n_sm:
        return (row_groups, bq, *_splits(blocks, n_tiles, n_sm))
    return row_groups, bq, 1, n_tiles


def _tc_geometry(B: int, Tq: int, S: int, G: int, Hkv: int, n_sm: int):
    """Tensor-core forward launch geometry: (warps, bq, nsplit,
    tiles_per_split).

    A block holds 16 query rows a warp, the fewest of 1, 2, 4 or 8 warps
    that fit G x Tq (decode: one warp for G = 7); its bq tokens are the same
    for every query tile (Tq = 128, G = 7: 8 tiles of 16, not 7 of 18 and
    one of 2).  A block of 8 warps fills an SM, so the KV range is split
    only where the blocks would leave more than half the SMs idle (decode:
    16 blocks); prefill and training chunks run unsplit.
    """
    rows = G * Tq
    warps = next(w for w in (1, 2, 4, TC_FWD_WARPS) if rows <= 16 * w or w == TC_FWD_WARPS)
    n_qt = -(-Tq // min(Tq, 16 * warps // G))
    bq = -(-Tq // n_qt)
    blocks = n_qt * Hkv * B
    n_tiles = max(1, -(-S // BLOCK_K))
    if 2 * blocks <= n_sm:
        return (warps, bq, *_splits(blocks, n_tiles, n_sm))
    return warps, bq, 1, n_tiles


def _tc_wide_geometry(B: int, Tq: int, S: int, G: int, Hkv: int, n_sm: int):
    """Wide tensor-core forward launch geometry: (nsplit, tiles_per_split).

    A block holds 32 fold rows (token t, grouped head g as row t x G + g) of
    a KV head, so there are ceil(G x Tq / 32) x Hkv x B blocks; two fit an
    SM, so the 32-slot KV range is split (merged in the launch) where they
    would leave SMs without a block (decode at G = 128: 4 blocks a batch
    row), to about two blocks an SM."""
    blocks = -(-G * Tq // WIDE_ROWS) * Hkv * B
    n_tiles = max(1, -(-S // WIDE_BLOCK_K))
    if blocks < n_sm:
        return _splits(blocks, n_tiles, n_sm)
    return 1, n_tiles


def _tc_wide(kernels: str, G: int, hdk: int, hdv: int) -> bool:
    """Whether a call runs the wide tensor-core kernels (a head dim above
    MAX_HD); raises on what no kernel of ``kernels`` takes."""
    if kernels == "cuda_cores":
        if G > MAX_ROWS or hdk > MAX_HD or hdv > MAX_HD:
            raise ValueError(f"the CUDA-core kernels take G <= {MAX_ROWS} and head dims <= "
                             f"{MAX_HD}; got G={G}, hd_k={hdk}, hd_v={hdv}")
        return False
    if G > MAX_G_TC or hdk > WIDE_HD_K or hdv > WIDE_HD_V:
        raise ValueError(f"the tensor-core kernels take G <= {MAX_G_TC}, hd_k <= {WIDE_HD_K} "
                         f"and hd_v <= {WIDE_HD_V}; got G={G}, hd_k={hdk}, hd_v={hdv}")
    return hdk > MAX_HD or hdv > MAX_HD


def _ticket_groups(B: int, Tq: int, Hkv: int, bq: int) -> int:
    """Split counters a tensor-core forward call needs: one per (query
    tile, KV head, batch row) group."""
    return -(-Tq // bq) * Hkv * B


def _ticket_buffer(dev, n: int):
    """The tensor-core forward's split counters on ``dev``: int32 zeros,
    allocated once and grown when a call needs more.  Each call leaves them
    zero, so calls share them safely only in order: on one stream, as every
    path of the port issues its calls."""
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _tickets[dev] = buf
    return buf


def _pick_kernels(kernels, dtype, what: str) -> str:
    """The kernels a call runs: ``kernels`` if given (``"tensor_cores"``,
    bf16 only, or ``"cuda_cores"``), else the tensor cores for bf16 and the
    CUDA cores for fp32."""
    if kernels is None:
        return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
    if kernels not in KERNELS:
        raise ValueError(f"kernels must be one of {KERNELS}, got {kernels!r}")
    if kernels == "tensor_cores" and dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core {what} takes bfloat16 q, k and v, got "
                        f"{dtype}; fp32 runs on the CUDA cores")
    return kernels


def _check_vec(name: str, t, hd: int):
    """The kernels load K and V (the tensor-core forward and the backward Q
    too) in 16-byte vectors: the base, the strides and the head dim must be
    whole vectors."""
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


def _check_inputs(q, k, v, q_pos, kv_pos, q_start, fn: str):
    """Validate what both kernels take; returns ((B, Tq, S, H, Hkv, hdk,
    hdv), kv_pos, (q_pos, batch stride), (q_start, batch stride))."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors; the plain version is "
                         "kernels/ref.py")
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
    _check_vec("k", k, hdk)
    _check_vec("v", v, hdv)
    if kv_pos.device != dev or kv_pos.dim() != 1 or kv_pos.shape[0] != S:
        raise ValueError(f"kv_pos must be [{S}] on {dev}")
    kv_pos = kv_pos.to(torch.int32).contiguous()
    qp = _positions(q_pos, B, Tq, dev, "q_pos")
    qs = (None, 0) if q_start is None else _positions(q_start, B, Tq, dev, "q_start")
    return (B, Tq, S, H, Hkv, hdk, hdv), kv_pos, qp, qs


def flash_attention_partial(q, k, v, q_pos, kv_pos, *, causal=True,
                            scale=None, q_start=None, kernels=None):
    """Partial flash attention on the card.

    q: [B, Tq, H, hd_k]; k: [B, S, Hkv, hd_k]; v: [B, S, Hkv, hd_v], all
    float32 or all bfloat16 on one CUDA device, last dim contiguous (other
    strides are free: K and V may be views of a larger cache, 16-byte
    aligned, with head dims and strides of whole 16-byte vectors; on the
    tensor cores q too);
    q_pos and q_start: [Tq] or [B, Tq] int; kv_pos: [S] int (2**30 = empty).
    ``kernels`` picks the kernel: ``"tensor_cores"`` (csrc/flash_partial_tc.cu,
    bf16 only) or ``"cuda_cores"`` (csrc/flash_partial.cu and its merge
    kernel, fp32 and bf16); None, the default and the only choice of the
    model's paths, takes the tensor cores for bf16 and the CUDA cores for fp32.
    Returns (o [B,Tq,H,hd_v] f32 un-normalized, m [B,Tq,H] f32, l [B,Tq,H] f32).
    """
    global launches, merge_launches, fwd_tc_launches, merged_in_kernel
    dims, kv_pos, (q_pos, qpos_sb), (q_start, qstart_sb) = _check_inputs(
        q, k, v, q_pos, kv_pos, q_start, "flash_attention_partial")
    B, Tq, S, H, Hkv, hdk, hdv = dims
    dev, G = q.device, H // Hkv
    kernels = _pick_kernels(kernels, q.dtype, "forward")
    wide = _tc_wide(kernels, G, hdk, hdv)
    if kernels == "tensor_cores":
        _check_vec("q", q, hdk)
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if wide:
        geometry = _tc_wide_geometry(B, Tq, S, G, Hkv, n_sm)
        nsplit = geometry[0]
    else:
        geometry = (_tc_geometry if kernels == "tensor_cores" else _geometry)(B, Tq, S, G, Hkv, n_sm)
        nsplit = geometry[2]

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    o, m, l = out(B, Tq, H, hdv), out(B, Tq, H), out(B, Tq, H)
    # the splits' partials: scratch that lives until the launch is queued
    parts = ((out(nsplit, B, Tq, H, hdv), out(nsplit, B, Tq, H), out(nsplit, B, Tq, H))
             if nsplit > 1 else ())
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            None if q_start is None else q_start.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *([t.data_ptr() for t in parts] or [None] * 3))
    tail = (B, Tq, S, H, Hkv, hdk, hdv, *geometry, qpos_sb, qstart_sb,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    if kernels == "tensor_cores":
        lib = _load("fwd_tc")
        groups = (-(-G * Tq // WIDE_ROWS) * Hkv * B if wide
                  else _ticket_groups(B, Tq, Hkv, geometry[1]))
        tickets = _ticket_buffer(dev, groups).data_ptr() if nsplit > 1 else None
        entry = lib.flash_partial_fwd_tc_wide if wide else lib.flash_partial_fwd_tc
        with torch.cuda.device(dev):
            rc = entry(*head, tickets, *tail)
        if rc != 0:
            raise RuntimeError(f"flash_partial_fwd_tc launch failed: CUDA error {rc}")
        fwd_tc_launches += 1
        merged_in_kernel += int(nsplit > 1)
        return o, m, l

    lib = _load("fwd")
    with torch.cuda.device(dev):
        rc = lib.flash_partial_fwd(_DTYPES[q.dtype], *head, *tail)
    if rc != 0:
        raise RuntimeError(f"flash_partial_fwd launch failed: CUDA error {rc}")
    launches += 1
    merge_launches += int(nsplit > 1)
    return o, m, l


def flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl, *,
                                causal=True, scale=None, q_start=None,
                                kernels=None):
    """Backward of ``flash_attention_partial`` on the card: a dq kernel, then
    a dk/dv kernel.

    q, k, v, positions: as the forward takes them, except that q too is
    loaded in 16-byte vectors (base and strides whole vectors); do: [B, Tq,
    H, hd_v], m and dl: [B, Tq, H], the cotangents of the forward's o and l
    and its saved max (any float dtype and layout: they are made contiguous
    fp32, and do is copied to a 16-byte aligned buffer if it is not one).
    Rows with m = -1e30 contribute nothing, whatever their do, dl.
    ``kernels`` picks the pair: ``"tensor_cores"`` (csrc/flash_partial_bwd_tc.cu,
    bf16 inputs only) or ``"cuda_cores"`` (csrc/flash_partial_bwd.cu, fp32
    and bf16); None, the default and the only choice of the model's paths,
    takes the tensor cores for bf16 and the CUDA cores for fp32.
    Returns fp32 (dq [B,Tq,H,hd_k], dk [B,S,Hkv,hd_k], dv [B,S,Hkv,hd_v]).
    """
    global bwd_dq_launches, bwd_dkv_launches, bwd_dq_tc_launches, bwd_dkv_tc_launches
    dims, kv_pos, (q_pos, qpos_sb), (q_start, qstart_sb) = _check_inputs(
        q, k, v, q_pos, kv_pos, q_start, "flash_attention_partial_bwd")
    B, Tq, S, H, Hkv, hdk, hdv = dims
    dev, G = q.device, H // Hkv
    kernels = _pick_kernels(kernels, q.dtype, "backward")
    wide = _tc_wide(kernels, G, hdk, hdv)
    if S == 0:
        raise ValueError("the backward needs S >= 1 KV slots")
    _check_vec("q", q, hdk)
    want = {"do": (B, Tq, H, hdv), "m": (B, Tq, H), "dl": (B, Tq, H)}
    got = {"do": do, "m": m, "dl": dl}
    for name, shape in want.items():
        t = got[name]
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} on {dev}, got "
                             f"{list(t.shape)} on {t.device}")
    do, m, dl = (t.to(torch.float32).contiguous() for t in (do, m, dl))
    if do.data_ptr() % 16:  # both pairs read do's rows in 16-byte vectors
        do = do.clone()
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dq, dk, dv = out(B, Tq, H, hdk), out(B, S, Hkv, hdk), out(B, S, Hkv, hdv)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    tail = (float(scale), int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    q_start_ptr = None if q_start is None else q_start.data_ptr()
    if kernels == "tensor_cores":
        lib = _load("bwd_tc")
        # the dq kernel writes, in fold order (row token * G + g of a KV head),
        # do's three bf16 terms, a copy of q and each row's positions, max and
        # dl, and the dk/dv kernel reads them as consecutive rows
        fold = (B, Hkv, Tq * G)
        split = torch.empty((SPLIT_TERMS, *fold, hdv), dtype=torch.bfloat16, device=dev)
        q_fold = torch.empty((*fold, hdk), dtype=torch.bfloat16, device=dev)
        rows = torch.empty((*fold, 4), dtype=torch.int32, device=dev)
        # the wide pair's blocks are fixed (32 fold rows, 32 slots); the
        # narrow dq kernel's take bq tokens of G rows
        shape = ((B, Tq, S, H, Hkv, hdk, hdv) if wide
                 else (B, Tq, S, H, Hkv, hdk, hdv, min(Tq, TC_DQ_ROWS // G)))
        entry = lib.flash_partial_bwd_tc_wide if wide else lib.flash_partial_bwd_tc
        for which in (0, 1):
            with torch.cuda.device(dev):
                rc = entry(
                    which, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    m.data_ptr(), dl.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
                    q_start_ptr, split.data_ptr(), q_fold.data_ptr(), rows.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *shape, qpos_sb, qstart_sb,
                    *strides, *tail)
            if rc != 0:
                raise RuntimeError(f"flash_partial_bwd_tc ({('dq', 'dkv')[which]}) launch "
                                   f"failed: CUDA error {rc}")
            if which == 0:
                bwd_dq_tc_launches += 1
            else:
                bwd_dkv_tc_launches += 1
        return dq, dk, dv

    lib = _load("bwd")
    row_groups, bq = _rows(Tq, G)
    for which, name in enumerate(("dq", "dkv")):
        with torch.cuda.device(dev):
            rc = lib.flash_partial_bwd(
                which, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), m.data_ptr(), dl.data_ptr(),
                q_pos.data_ptr(), kv_pos.data_ptr(), q_start_ptr,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Tq, S, H, Hkv, hdk, hdv, row_groups, bq, qpos_sb, qstart_sb,
                *strides, *tail)
        if rc != 0:
            raise RuntimeError(f"flash_partial_bwd ({name}) launch failed: "
                               f"CUDA error {rc}")
        if name == "dq":
            bwd_dq_launches += 1
        else:
            bwd_dkv_launches += 1
    return dq, dk, dv


def partial_forward(q, k, v, q_pos, kv_pos, q_start, *, causal, scale,
                    block_k=512):
    """(o, m, l) by the tensor's device: the forward kernel for CUDA tensors
    (which raises on what it does not take), the plain version for CPU
    tensors.  ``block_k`` is the plain version's KV block."""
    if q.device.type == "cuda":
        return flash_attention_partial(q, k, v, q_pos, kv_pos, causal=causal,
                                       scale=scale, q_start=q_start)
    if q.device.type == "cpu":
        return _ref.attention_partial_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                          scale=scale, block_k=block_k,
                                          q_start=q_start)
    raise ValueError(f"attention runs on cuda or cpu, not {q.device}")


def partial_backward(q, k, v, q_pos, kv_pos, q_start, do, m, dl, *, causal,
                     scale, block_k=512):
    """fp32 (dq, dk, dv) by the tensor's device, as ``partial_forward``: the
    backward kernels the dtype picks (tensor cores for bf16, CUDA cores for
    fp32), or ``attention_partial_bwd_ref``."""
    if q.device.type == "cuda":
        return flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl,
                                           causal=causal, scale=scale,
                                           q_start=q_start)
    if q.device.type == "cpu":
        return _ref.attention_partial_bwd_ref(q, k, v, q_pos, kv_pos, q_start,
                                              do, m, dl, causal=causal,
                                              scale=scale, block_k=block_k)
    raise ValueError(f"attention runs on cuda or cpu, not {q.device}")


class FlashPartial(torch.autograd.Function):
    """Differentiable partial flash attention: the counterpart of the
    reference's ``custom_vjp`` (``_flash_partial`` with ``_fwd`` / ``_bwd``).

    ``FlashPartial.apply(q, k, v, q_pos, kv_pos, q_start, causal, scale,
    block_k)`` returns the un-normalized (o, m, l).  The residuals are
    (q, k, v, q_pos, kv_pos, q_start, o, m, l), as in the reference; the
    backward reads m only.  m is gradient-frozen (its cotangent is dropped),
    the integer positions get no gradient, and dq, dk, dv come back in the
    dtypes of q, k, v.  Ragged Tq and S need no padding: the kernels and the
    plain version mask them.
    """

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_start, causal, scale, block_k):
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        o, m, l = partial_forward(q, k, v, q_pos, kv_pos, q_start,
                                  causal=causal, scale=scale, block_k=block_k)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, q_start, o, m, l)
        ctx.opts = dict(causal=causal, scale=scale, block_k=block_k)
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, dl):
        # an output the loss does not read arrives as zeros (autograd
        # materializes undefined grads of a Function)
        q, k, v, q_pos, kv_pos, q_start, _o, m, _l = ctx.saved_tensors
        dq, dk, dv = partial_backward(q, k, v, q_pos, kv_pos, q_start, do, m,
                                      dl, **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)
