"""The mega backend's four fused decode kernels.

Counterparts of the Pallas kernels in ``triton_dist_tpu/megakernel/kernels.py``:

* ``fused_ln_qkv_rope`` (``_ln_qkv_rope_kernel``): RMSNorm → QKV projection
  → per-head q/k RMSNorm → split-half RoPE; ``csrc/mega_ln_qkv_rope.cu``.
* ``fused_attn_back`` (``_attn_back_kernel``): splice of the new K/V row →
  flash-decode sweep → o-projection partial in fp32;
  ``csrc/mega_attn_back.cu``.
* ``fused_mlp_block`` (``_mlp_block_kernel``): RMSNorm → gate/up → SwiGLU →
  down projection; ``csrc/mega_mlp_block.cu``.
* ``fused_norm_head`` (``_norm_head_kernel``): final RMSNorm → ``lm_head``,
  fp32 logits; ``csrc/mega_norm_head.cu``.

On a CUDA tensor each wrapper launches its hand-written kernel on the
current stream (each source's header says what bounds it on the H100 and
how its design answers that); on a CPU tensor it runs its plain PyTorch
version (``*_reference``), and nothing else. The kernels take a decode
batch of at most ``MAX_ROWS`` rows. The ``megakernel`` package exports
these wrappers under the JAX module's names (``megakernel/kernels.py``);
they live here, with the other kernel wrappers, so that the launch-count
registry in ``kernels/__init__.py`` needs no import of ``megakernel``.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.flash_decode import decode_reference
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.kernels.norm_rope import apply_rope, rmsnorm

#: Rows (decode slots) one launch takes: the kernels keep one fp32
#: accumulator per row in registers.
MAX_ROWS = 8
#: Columns of one weight tile: eight 16-byte column groups of bf16.
TILE_N = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mega_ln_qkv_rope": {"tdt_ln_qkv_rope": [_P] * 10 + [_I] * 6 + [_F, _F, _I, _P]},
    "mega_attn_back": {"tdt_attn_back": [_P] * 10 + [_I] * 6 + [_F, _I, _P]},
    "mega_mlp_block": {"tdt_mlp_block": [_P] * 7 + [_I] * 4 + [_F, _I, _P]},
    "mega_norm_head": {"tdt_norm_head": [_P] * 4 + [_I] * 4 + [_F, _I, _P]},
}


# ------------------------------------------------------------ plain versions

def ln_qkv_rope_reference(x, ln_w, wqkv, q_norm, k_norm, pos, *, num_q_heads: int,
                          num_kv_heads: int, head_dim: int, rope_theta: float = 1e6,
                          eps: float = 1e-6):
    """Plain ``fused_ln_qkv_rope``: the projection is rounded to the model
    dtype before the head norms; v is the raw projection."""
    b = x.shape[0]
    hq, hkv, hd = num_q_heads, num_kv_heads, head_dim
    xn = rmsnorm(x, ln_w, eps)
    h3 = matmul_f32(xn, wqkv).to(x.dtype).reshape(b, hq + 2 * hkv, hd)
    q = apply_rope(rmsnorm(h3[:, :hq], q_norm, eps), pos, rope_theta)
    k = apply_rope(rmsnorm(h3[:, hq:hq + hkv], k_norm, eps), pos, rope_theta)
    return q.reshape(b, -1), k.reshape(b, -1), h3[:, hq + hkv:].reshape(b, -1).contiguous()


def _splice(cache: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """A copy of ``cache`` (B, Hkv, S, D) with ``new`` (B, Hkv, D) at row
    ``lengths[b]``; a slot whose length is S gets nothing (JAX's
    out-of-bounds scatter drops)."""
    out = cache.clone()
    s = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = lengths.long().clamp(min=0, max=s - 1)
    keep = (lengths < s)[:, None, None]
    out[rows, :, idx] = torch.where(keep, new, out[rows, :, idx])
    return out


def attn_back_reference(q, k_new, v_new, k_cache, v_cache, lengths, wo, *,
                        scale: float | None = None) -> torch.Tensor:
    """Plain ``fused_attn_back``: splice → decode over ``lengths + 1`` keys
    (o rounded to q's dtype) → o-projection, one kv-head group's rows of
    ``wo`` at a time, summed in fp32 in head order."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    rows = hq // hkv * d
    o = decode_reference(q, _splice(k_cache, k_new, lengths), _splice(v_cache, v_new, lengths),
                         lengths + 1, scale=scale).reshape(b, hq * d)
    out = torch.zeros((b, wo.shape[1]), dtype=torch.float32, device=q.device)
    for h in range(hkv):
        out += matmul_f32(o[:, h * rows:(h + 1) * rows], wo[h * rows:(h + 1) * rows])
    return out


def mlp_block_reference(x, ln_w, w_gate, w_up, w_down, *, eps: float = 1e-6,
                        residual: bool = False) -> torch.Tensor:
    """Plain ``fused_mlp_block``: h = silu(g)·u is rounded to the model dtype
    before the down product, which accumulates in fp32."""
    xn = rmsnorm(x, ln_w, eps)
    h = (torch.nn.functional.silu(matmul_f32(xn, w_gate)) * matmul_f32(xn, w_up)).to(x.dtype)
    out = matmul_f32(h, w_down)
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


def norm_head_reference(x, norm_w, lm_head, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain ``fused_norm_head``: fp32 logits of the normalised rows."""
    return matmul_f32(rmsnorm(x, norm_w, eps), lm_head)


# ------------------------------------------------------------------ wrappers

def _check(name: str, tensors: dict, ints: tuple = ()) -> str:
    """Common checks; returns "cpu" or "cuda". ``ints`` names the int32
    operands; every other operand must share the first one's dtype."""
    first = next(iter(tensors.values()))
    if any(t.device != first.device for t in tensors.values()):
        raise ValueError(f"{name}: all operands must be on one device")
    if first.device.type == "cpu":
        return "cpu"
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {first.device}")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes fp32 or bf16, got {first.dtype}")
    for k, t in tensors.items():
        want = torch.int32 if k in ints else first.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {k} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands ({k} is not)")
    if first.dim() >= 1 and first.shape[0] > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} rows on CUDA, got {first.shape[0]}")
    return "cuda"


def _dtype_code(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_ln_qkv_rope(
    x: torch.Tensor,  # (B, d)
    ln_w: torch.Tensor,  # (d,)
    wqkv: torch.Tensor,  # (d, (hq + 2·hkv)·hd)
    q_norm: torch.Tensor,  # (hd,)
    k_norm: torch.Tensor,  # (hd,)
    pos: torch.Tensor,  # (B,) int32 absolute positions
    *,
    num_q_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float = 1e6,
    eps: float = 1e-6,
):
    """RMSNorm → QKV projection → per-head q/k RMSNorm → RoPE. Returns q
    (B, hq·hd), k and v (B, hkv·hd), contiguous, in x's dtype."""
    b, d = x.shape
    hq, hkv, hd = num_q_heads, num_kv_heads, head_dim
    cols = (hq + 2 * hkv) * hd
    if wqkv.shape != (d, cols) or ln_w.shape != (d,) or q_norm.shape != (hd,) \
            or k_norm.shape != (hd,) or pos.shape != (b,):
        raise ValueError(f"fused_ln_qkv_rope: bad shapes x {tuple(x.shape)}, wqkv {tuple(wqkv.shape)}, "
                         f"norms {tuple(q_norm.shape)}, pos {tuple(pos.shape)}")
    where = _check("fused_ln_qkv_rope", dict(x=x, ln_w=ln_w, wqkv=wqkv, q_norm=q_norm, k_norm=k_norm,
                                             pos=pos), ints=("pos",))
    if where == "cpu":
        return ln_qkv_rope_reference(x, ln_w, wqkv, q_norm, k_norm, pos, num_q_heads=hq,
                                     num_kv_heads=hkv, head_dim=hd, rope_theta=rope_theta, eps=eps)
    if d % 8 or hd % 2 or hd > 256:
        raise ValueError(f"fused_ln_qkv_rope needs d % 8 == 0 and an even head dim ≤ 256, got {d}, {hd}")
    # Split the d sweep so that the column tiles times the splits give about
    # two blocks per SM; each split keeps at least 256 rows of wqkv.
    tiles = -(-cols // TILE_N)
    splits = max(1, min(d // 256, -(-2 * _sm_count(x.device) // tiles)))
    q = torch.empty((b, hq * hd), device=x.device, dtype=x.dtype)
    k = torch.empty((b, hkv * hd), device=x.device, dtype=x.dtype)
    v = torch.empty_like(k)
    partial = torch.empty((splits, b, cols), device=x.device, dtype=torch.float32)
    lib = _build.load("mega_ln_qkv_rope", _SIGNATURES["mega_ln_qkv_rope"])
    with torch.cuda.device(x.device):
        code = lib.tdt_ln_qkv_rope(
            _build.ptr(x), _build.ptr(ln_w), _build.ptr(wqkv), _build.ptr(q_norm), _build.ptr(k_norm),
            _build.ptr(pos), _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(partial),
            b, d, hq, hkv, hd, splits, ctypes.c_float(rope_theta), ctypes.c_float(eps),
            _dtype_code(x), _build.stream_ptr(x.device),
        )
    _build.check(lib, code, "fused_ln_qkv_rope")
    fused_ln_qkv_rope.launches += 1
    return q, k, v


def fused_attn_back(
    q: torch.Tensor,  # (B, Hq, D) roped decode queries
    k_new: torch.Tensor,  # (B, Hkv, D) this step's K row, not yet in the cache
    v_new: torch.Tensor,  # (B, Hkv, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D) the cache before this step's append
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 valid length before the append
    wo: torch.Tensor,  # (Hq·D, n)
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """The new K/V row spliced in at ``lengths`` (nowhere where the length
    is S), the decode sweep over ``lengths + 1`` keys, and the o-projection:
    returns the fp32 (B, n) partial. The caches are not written."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"fused_attn_back: bad shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hq % hkv or k_new.shape != (b, hkv, d)
            or v_new.shape != (b, hkv, d) or lengths.shape != (b,) or wo.dim() != 2
            or wo.shape[0] != hq * d):
        raise ValueError(f"fused_attn_back: bad shapes q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
                         f"cache {tuple(k_cache.shape)}, lengths {tuple(lengths.shape)}, wo {tuple(wo.shape)}")
    where = _check("fused_attn_back", dict(q=q, k_new=k_new, v_new=v_new, k_cache=k_cache,
                                           v_cache=v_cache, wo=wo, lengths=lengths), ints=("lengths",))
    if where == "cpu":
        return attn_back_reference(q, k_new, v_new, k_cache, v_cache, lengths, wo, scale=scale)
    n = wo.shape[1]
    if d not in (32, 64, 128) or hq // hkv not in (1, 2, 4, 8) or n % 8:
        raise ValueError(f"fused_attn_back: unsupported head dim {d}, group {hq // hkv} or width {n}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, n), device=q.device, dtype=torch.float32)
    o = torch.empty_like(q)
    partial = torch.empty((hkv, b, n), device=q.device, dtype=torch.float32)
    lib = _build.load("mega_attn_back", _SIGNATURES["mega_attn_back"])
    with torch.cuda.device(q.device):
        code = lib.tdt_attn_back(
            _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(lengths), _build.ptr(wo), _build.ptr(out), _build.ptr(o), _build.ptr(partial),
            b, hq, hkv, s, d, n, ctypes.c_float(scale), _dtype_code(q), _build.stream_ptr(q.device),
        )
    _build.check(lib, code, "fused_attn_back")
    fused_attn_back.launches += 1
    return out


def fused_mlp_block(
    x: torch.Tensor,  # (B, d) block input (pre-norm residual stream)
    ln_w: torch.Tensor,  # (d,)
    w_gate: torch.Tensor,  # (d, ff)
    w_up: torch.Tensor,  # (d, ff)
    w_down: torch.Tensor,  # (ff, d)
    *,
    eps: float = 1e-6,
    residual: bool = False,
) -> torch.Tensor:
    """RMSNorm → gate/up → SwiGLU → down in x's dtype (the down-projection
    partial; ``residual`` adds x before the cast)."""
    b, d = x.shape
    ff = w_gate.shape[1] if w_gate.dim() == 2 else -1
    if ln_w.shape != (d,) or w_gate.shape != (d, ff) or w_up.shape != (d, ff) or w_down.shape != (ff, d):
        raise ValueError(f"fused_mlp_block: bad shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    where = _check("fused_mlp_block", dict(x=x, ln_w=ln_w, w_gate=w_gate, w_up=w_up, w_down=w_down))
    if where == "cpu":
        return mlp_block_reference(x, ln_w, w_gate, w_up, w_down, eps=eps, residual=residual)
    if d % 8 or ff % 8:
        raise ValueError(f"fused_mlp_block needs d and ff multiples of 8, got {d}, {ff}")
    out = torch.empty_like(x)
    partial = torch.empty((-(-ff // TILE_N), b, d), device=x.device, dtype=torch.float32)
    lib = _build.load("mega_mlp_block", _SIGNATURES["mega_mlp_block"])
    with torch.cuda.device(x.device):
        code = lib.tdt_mlp_block(
            _build.ptr(x), _build.ptr(ln_w), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(w_down),
            _build.ptr(out), _build.ptr(partial), b, d, ff, int(residual), ctypes.c_float(eps),
            _dtype_code(x), _build.stream_ptr(x.device),
        )
    _build.check(lib, code, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


def fused_norm_head(
    x: torch.Tensor,  # (B, d) residual stream after the last layer
    norm_w: torch.Tensor,  # (d,)
    lm_head: torch.Tensor,  # (d, V)
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Final RMSNorm → ``lm_head``: fp32 logits (B, V)."""
    b, d = x.shape
    if norm_w.shape != (d,) or lm_head.dim() != 2 or lm_head.shape[0] != d:
        raise ValueError(f"fused_norm_head: bad shapes x {tuple(x.shape)}, lm_head {tuple(lm_head.shape)}")
    where = _check("fused_norm_head", dict(x=x, norm_w=norm_w, lm_head=lm_head))
    if where == "cpu":
        return norm_head_reference(x, norm_w, lm_head, eps=eps)
    vocab = lm_head.shape[1]
    if d % 8 or vocab % 8:
        raise ValueError(f"fused_norm_head needs d and V multiples of 8, got {d}, {vocab}")
    out = torch.empty((b, vocab), device=x.device, dtype=torch.float32)
    # Blocks walk the vocab tiles in turn: about two per SM, so each block
    # normalises x once for many tiles.
    grid = min(-(-vocab // TILE_N), 2 * _sm_count(x.device))
    lib = _build.load("mega_norm_head", _SIGNATURES["mega_norm_head"])
    with torch.cuda.device(x.device):
        code = lib.tdt_norm_head(
            _build.ptr(x), _build.ptr(norm_w), _build.ptr(lm_head), _build.ptr(out), b, d, vocab, grid,
            ctypes.c_float(eps), _dtype_code(x), _build.stream_ptr(x.device),
        )
    _build.check(lib, code, "fused_norm_head")
    fused_norm_head.launches += 1
    return out


#: Kernel launches so far (CUDA calls only; the CPU path launches nothing).
#: A call counts once, whatever number of passes of its source it launches
#: (a kernel and its fixed-order reduction).
fused_ln_qkv_rope.launches = 0
fused_attn_back.launches = 0
fused_mlp_block.launches = 0
fused_norm_head.launches = 0


# ---------------------------------------------- bytes and FLOPs, for bounds

def ln_qkv_rope_cost(x, wqkv) -> tuple[int, int]:
    """(FLOPs, bytes): x, ln_w, wqkv and the head norms read once, q, k, v
    written once; the products' 2·B·d·cols FLOPs."""
    b, d = x.shape
    cols = wqkv.shape[1]
    e = x.element_size()
    nbytes = e * (b * d + d + d * cols + b * cols) + 4 * b
    return 2 * b * d * cols, nbytes


def attn_back_cost(q, k_cache, lengths, wo) -> tuple[int, int]:
    """(FLOPs, bytes) for these lengths: the cache rows below each length
    (the new row comes from k_new/v_new), q, the new rows and wo read once,
    the fp32 output written once; 4·D FLOPs per (query head, valid key) and
    the o-projection's 2·B·Hq·D·n."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    n = wo.shape[1]
    lens = lengths.long()
    cached = int(torch.clamp(lens, 0, s).sum())
    keys = int(torch.clamp(lens + 1, 0, s).sum())
    e = q.element_size()
    nbytes = e * (q.numel() + 2 * b * hkv * d + 2 * cached * hkv * d + wo.numel()) + 4 * b + 4 * b * n
    return 4 * d * hq * keys + 2 * b * hq * d * n, nbytes


def mlp_block_cost(x, w_gate) -> tuple[int, int]:
    """(FLOPs, bytes): x, ln_w and the three weights read once, the output
    written once; 6·B·d·ff FLOPs."""
    b, d = x.shape
    ff = w_gate.shape[1]
    return 6 * b * d * ff, x.element_size() * (2 * b * d + d + 3 * d * ff)


def norm_head_cost(x, lm_head) -> tuple[int, int]:
    """(FLOPs, bytes): x, the norm weight and lm_head read once, fp32
    logits written once; 2·B·d·V FLOPs."""
    b, d = x.shape
    vocab = lm_head.shape[1]
    return 2 * b * d * vocab, x.element_size() * (b * d + d + d * vocab) + 4 * b * vocab
