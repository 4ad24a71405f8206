"""Attention test cases shared by the port's CPU parity tests and its card
tests.  Imports no JAX: the machine with the card has none."""
import numpy as np
import torch

PAD = 2**30

SWEEP = [  # tests/test_kernels.py's grid
    # B, Tq,  S,   H, Hkv, hd, hv, causal, q_off, dtype
    (1, 16, 16, 4, 4, 32, 32, True, 0, "float32"),
    (2, 32, 64, 4, 2, 16, 16, True, 32, "float32"),
    (1, 8, 128, 8, 1, 64, 32, True, 120, "float32"),   # MLA-like hv != hd
    (2, 17, 33, 6, 2, 16, 16, True, 16, "float32"),    # ragged sizes
    (1, 16, 48, 4, 4, 32, 32, False, 0, "float32"),    # bidirectional
    (1, 1, 64, 4, 2, 32, 32, True, 63, "float32"),     # decode: Tq=1
    (1, 32, 32, 4, 4, 32, 32, True, 0, "bfloat16"),
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the dead rows of window_case(): o = l = 0 and m = -1e30 exactly
WINDOW_DEAD = np.array([[0, 0, 0, 0, 0, 0, 0, 1], [1, 0, 0, 0, 0, 0, 1, 1]], bool)


def tol(dtype):
    """The reference's tolerances: 1e-5 for fp32, 2e-2 for bf16 inputs."""
    return 2e-2 if dtype == "bfloat16" else 1e-5


def inputs(B, Tq, S, H, Hkv, hd, hv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, hd), np.float32),
            rng.standard_normal((B, S, Hkv, hd), np.float32),
            rng.standard_normal((B, S, Hkv, hv), np.float32))


def sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff):
    """(q, k, v) arrays and q_pos / kv_pos for one SWEEP row."""
    return (inputs(B, Tq, S, H, Hkv, hd, hv),
            np.arange(Tq, dtype=np.int32) + qoff, np.arange(S, dtype=np.int32))


def window_case():
    """Per-row positions with a q_start window, PAD dead rows and a row whose
    every kv slot lies in its future: (q, k, v), q_pos, kv_pos, q_start.
    S spans several 64-slot tiles, so the card kernel splits the KV range
    and merges partials of which some are fully masked."""
    B, Tq, S, H, Hkv, hd = 2, 8, 200, 4, 2, 16
    arrays = inputs(B, Tq, S, H, Hkv, hd, hd, seed=5)
    q_pos = np.stack([np.arange(Tq) + 16, np.arange(Tq) + 8]).astype(np.int32)
    q_start = np.array([[0, 0, 4, 4, 4, 20, 20, PAD],
                        [0, 3, 3, 3, 9, 9, PAD, PAD]], np.int32)
    kv_pos = np.arange(S, dtype=np.int32) + 2
    kv_pos[-3:] = PAD                      # empty cache slots
    q_pos[1, 0] = 1                        # sees nothing: every kv_pos >= 2
    return arrays, q_pos, kv_pos, q_start


def to_torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DT[dtype])
            for a in arrays]


def to_np(x):
    return np.asarray(x.float().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)
