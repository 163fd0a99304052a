"""Inference engine at world 1: counterpart of ``triton_dist_tpu/models/engine.py``
(``sample_token``, ``Engine.serve``, ``alloc_slots``, ``prefill_into_slot``,
``decode_steps``, and the paged-KV entry points ``alloc_paged``,
``paged_kbuf_zeros``, ``prefill_chunk``, ``complete_paged_prefill``,
``decode_steps_paged``).

PyTorch runs eagerly, so where JAX jit-compiles one program per shape and
loops on the device with ``fori_loop``, this engine calls the model step by
step from a Python loop (CUDA graphs are later work). The model is a
``DenseLLM`` or a ``Qwen3MoE``; the engine does not look at its MLP. The
backends ``xla``, ``dist`` and ``dist_ar`` are ported (at world 1 the
dense layers compute the same in each; the MoE layers' ``xla`` mode uses
plain grouped GEMMs), and ``mega``: prefill in ``dist_ar`` mode, every
decode step one recorded task graph lowered to the fused decode kernels
(``megakernel/``), over the contiguous slot cache or, paged, directly over
the block pool. The other backends decode a paged pool by gathering it into
the contiguous layout, running ``decode_steps`` and scattering the chunk's
rows back. Caches and pools are updated in place.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_decode import gather_paged_kv
from triton_dist_tpu_torch.models.dense import DenseLLM
from triton_dist_tpu_torch.models.kv_cache import NULL_BLOCK, KVCache, PagedKVCache

_BACKENDS = ("xla", "dist", "dist_ar", "mega")
# Every backend resolves in both maps. mega prefills op by op in dist_ar
# mode (its task graph is decode-shaped: one token per slot per step) and
# decodes fused.
PREFILL_MODE = {"xla": "xla", "dist": "dist", "dist_ar": "dist_ar", "mega": "dist_ar"}
DECODE_MODE = {"xla": "xla", "dist": "dist_ar", "dist_ar": "dist_ar", "mega": "mega"}
# Chunked (paged) prefill runs in a replicated mode.
CHUNK_MODE = {"xla": "xla", "dist": "dist_ar", "dist_ar": "dist_ar", "mega": "dist_ar"}
#: What prefix reuse and speculative decoding wait for.
PREFIX_REUSE = ("prefix reuse (paged_seed_kbuf) comes with the serving scheduler and server, "
                "ROADMAP queue 1 item A")
SPECULATIVE = ("speculative decoding (the drafter, spec_decode_steps and its paged twin) is "
               "ROADMAP queue 1 item C")


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 method: str = "greedy", temperature: float = 1.0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Greedy / temperature / nucleus sampling of (B, V) fp32 logits → (B,)
    int32. Greedy is ``argmax`` (first maximum on ties, as JAX). The random
    methods draw from ``generator``; their numbers differ from ``jax.random``."""
    if method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    logits = logits.float() / max(temperature, 1e-6)
    if method == "top_p" and top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        # Keep every token whose preceding cumulative mass is ≤ top_p (the
        # first token always survives).
        prev_mass = torch.cumsum(probs, dim=-1) - probs
        masked = torch.where(prev_mass <= top_p, sorted_logits,
                             torch.full_like(sorted_logits, float("-inf")))
        choice = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)
        return torch.gather(sorted_idx, 1, choice)[:, 0].to(torch.int32)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0].to(torch.int32)


class Engine:
    """Serves a ``DenseLLM`` or ``Qwen3MoE``: one-shot ``serve`` and the
    slot-granular ``alloc_slots`` / ``prefill_into_slot`` / ``decode_steps``
    of continuous batching."""

    def __init__(self, model: DenseLLM, backend: str = "dist", max_len: int = 512,
                 sample: str = "greedy", temperature: float = 1.0, top_p: float = 1.0):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {_BACKENDS}")
        self.model = model
        self.backend = backend
        self.max_len = max_len
        self.sample_method = sample
        self.temperature = temperature
        self.top_p = top_p
        self.prefill_mode = PREFILL_MODE[backend]
        self.decode_mode = DECODE_MODE[backend]
        self.chunk_mode = CHUNK_MODE[backend]
        self.kv_cache: KVCache | None = None
        if backend == "mega":
            # Built once: the step functions (contiguous and paged) and the
            # per-layer weight views.
            self._mega_step = model.mega_step_fn()
            self._mega_paged_step = model.mega_step_fn(paged=True)
            self._mega_layers = model.split_layer_params()

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _sample(self, logits, generator):
        return sample_token(logits, generator, self.sample_method, self.temperature, self.top_p)

    def _decode(self, token, cache: KVCache, lengths):
        if self.decode_mode == "mega":
            logits, _, _ = self.model.decode_mega(self._mega_step, self._mega_layers, token,
                                                  cache.k, cache.v, lengths)
        else:
            logits, _, _ = self.model.decode(token, cache.k, cache.v, lengths, mode=self.decode_mode)
        return logits

    # ------------------------------------------------------------------ kv
    def _make_cache(self, ks: torch.Tensor, vs: torch.Tensor, seq: int) -> KVCache:
        """Prefill caches padded with zeros to ``max_len`` into a KVCache."""
        if ks.shape[3] < self.max_len:
            shape = ks.shape[:3] + (self.max_len,) + ks.shape[4:]
            kp, vp = ks.new_zeros(shape), vs.new_zeros(shape)
            kp[:, :, :, : ks.shape[3]] = ks
            vp[:, :, :, : vs.shape[3]] = vs
            ks, vs = kp, vp
        lengths = torch.full((ks.shape[1],), seq, dtype=torch.int32, device=ks.device)
        return KVCache(k=ks, v=vs, lengths=lengths)

    # ------------------------------------------------- serving (slot-granular)
    def alloc_slots(self, num_slots: int) -> KVCache:
        """Zeroed KV for a fixed batch of ``num_slots`` serving slots, each
        owning a full ``max_len`` row."""
        c = self.model.config
        return KVCache.create(
            c.num_layers, num_slots, c.num_kv_heads, self.max_len, c.head_dim,
            dtype=self.model.params.embed.dtype, device=self.device,
        )

    def prefill_into_slot(self, cache: KVCache, slot: int, input_ids,
                          generator: torch.Generator | None = None):
        """Prefill one request (batch 1) and write its KV into slot ``slot``
        of ``cache``, zeroing the rest of the slot's row so no earlier
        tenant's KV survives. Returns ``(token0, cache)``: the first
        generated token (a 0-d int32 tensor) and the cache, updated in place
        with the slot's length set to the prompt length."""
        ids = torch.as_tensor(input_ids, device=self.device)
        bsz, seq = ids.shape
        if bsz != 1:
            raise ValueError("prefill_into_slot joins one request at a time")
        if seq > self.max_len:
            raise ValueError(f"prompt of {seq} tokens exceeds max_len={self.max_len}")
        logits, (ks, vs) = self.model.prefill(ids, mode=self.prefill_mode)
        cache.k[:, slot, :, :seq] = ks[:, 0]
        cache.k[:, slot, :, seq:] = 0
        cache.v[:, slot, :, :seq] = vs[:, 0]
        cache.v[:, slot, :, seq:] = 0
        cache.lengths[slot] = seq
        token0 = self._sample(logits, generator)
        return token0[0], cache

    def _decode_loop(self, step, tokens, remaining, lengths0: torch.Tensor, chunk: int, generator):
        """``chunk`` steps of ``step(token, lengths, active) -> logits`` with
        a per-slot active mask (``remaining > 0``): inactive slots re-feed
        their last token, emit -1 and keep their lengths frozen. Returns
        ``(out (B, chunk) int32, last_tokens (B,), lengths', remaining')``."""
        token = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        remaining = torch.as_tensor(remaining, device=self.device).to(torch.int32).clone()
        lengths = lengths0.clone()
        out = torch.full((token.shape[0], chunk), -1, dtype=torch.int32, device=self.device)
        for i in range(chunk):
            active = remaining > 0
            nxt = self._sample(step(token, lengths, active), generator)
            nxt = torch.where(active, nxt, token)
            out[:, i] = torch.where(active, nxt, torch.full_like(nxt, -1))
            step_ = active.to(torch.int32)
            lengths += step_
            remaining -= step_
            token = nxt
        return out, token, lengths, remaining

    def decode_steps(self, cache: KVCache, tokens, remaining, chunk: int,
                     generator: torch.Generator | None = None):
        """``chunk`` decode steps over the slot batch with a per-slot active
        mask (``remaining > 0``): inactive slots re-feed their last token,
        emit -1 and keep their lengths frozen. Returns ``(out (B, chunk)
        int32, last_tokens (B,), cache, remaining')``; ``cache`` is updated
        in place."""
        out, token, lengths, remaining = self._decode_loop(
            lambda tok, lens, act: self._decode(tok, cache, lens), tokens, remaining, cache.lengths,
            chunk, generator)
        cache.lengths.copy_(lengths)
        return out, token, cache, remaining

    # ----------------------------------------------- serving (paged blocks)
    def alloc_paged(self, num_slots: int, *, block_size: int, num_blocks: int,
                    quant: str | None = None) -> PagedKVCache:
        """A fresh paged KV: a zeroed global pool of ``num_blocks`` blocks of
        ``block_size`` rows and all-NULL per-slot block tables sized for
        ``max_len``. Block 0 is the reserved NULL block (``BlockAllocator``
        never hands it out). The caller sets ``tables`` and ``lengths``.
        ``quant`` pools are not ported (ROADMAP queue 1 item E)."""
        c = self.model.config
        return PagedKVCache.create(
            c.num_layers, num_slots, c.num_kv_heads, c.head_dim, block_size=block_size,
            num_blocks=num_blocks, max_len=self.max_len, dtype=self.model.params.embed.dtype,
            device=self.device, quant=quant,
        )

    def paged_kbuf_zeros(self, p_len: int):
        """Zeroed (L, 1, Hkv, p_len, D) chunked-prefill context buffers, K
        and V."""
        c = self.model.config
        shape = (c.num_layers, 1, c.num_kv_heads, p_len, c.head_dim)
        dt = self.model.params.embed.dtype
        return (torch.zeros(shape, dtype=dt, device=self.device),
                torch.zeros(shape, dtype=dt, device=self.device))

    def paged_seed_kbuf(self, paged: PagedKVCache, table_row, shared_rows: int, p_len: int):
        """Context buffers seeded with a reused prefix: not ported yet."""
        raise NotImplementedError(PREFIX_REUSE)

    @torch.no_grad()
    def prefill_chunk(self, kbuf, vbuf, chunk_ids, off: int, last_idx: int):
        """One chunk of an incremental prefill against the running context
        buffers (written in place). ``chunk_ids`` (1, C), the final chunk
        padded to C (rows past the buffer are dropped); ``off`` is the
        chunk's absolute start, ``last_idx`` the row whose logits matter
        (the prompt's last token, on the final chunk). Returns (logits
        (1, V) fp32, kbuf, vbuf)."""
        ids = torch.as_tensor(chunk_ids, device=self.device)
        logits, (kbuf, vbuf) = self.model.prefill_chunk(ids, kbuf, vbuf, int(off), int(last_idx),
                                                        mode=self.chunk_mode)
        return logits, kbuf, vbuf

    @torch.no_grad()
    def complete_paged_prefill(self, paged: PagedKVCache, kbuf, vbuf, table_row,
                               start_block: int) -> PagedKVCache:
        """Scatter a finished prefill's context buffers into the pool along
        the slot's block chain ``table_row``, block by block; blocks below
        ``start_block`` are prefix-shared and redirect to the NULL block
        instead of being rewritten. The pools are written in place; the
        tables and lengths are the caller's to update."""
        bs = paged.block_size
        nl, _, hkv, p_len, hd = kbuf.shape
        mbf = -(-p_len // bs)
        row = torch.as_tensor(table_row, device=self.device).to(torch.long)
        if row.numel() < mbf:
            raise ValueError(f"a table row of {row.numel()} blocks cannot hold {p_len} rows of {bs}")
        owned = torch.arange(mbf, device=self.device) >= start_block
        phys = torch.where(owned, row[:mbf], torch.full_like(row[:mbf], NULL_BLOCK))

        def blocks_of(buf):  # (L, 1, Hkv, P, D) → (L, mbf, Hkv, bs, D)
            x = torch.nn.functional.pad(buf[:, 0], (0, 0, 0, mbf * bs - p_len))
            return x.reshape(nl, hkv, mbf, bs, hd).transpose(1, 2)

        paged.k[:, phys] = blocks_of(kbuf)
        paged.v[:, phys] = blocks_of(vbuf)
        return paged

    @torch.no_grad()
    def decode_steps_paged(self, paged: PagedKVCache, tokens, remaining, chunk: int,
                           generator: torch.Generator | None = None):
        """Paged ``decode_steps``, with the same active-mask rules. On
        ``mega`` every step runs directly against the block pool (the paged
        step graph: tables and the active mask are data; an inactive slot
        writes to the NULL block). The other backends gather the pool into
        the contiguous layout, run ``decode_steps`` on it, then scatter each
        slot's rows written in this chunk back along its table, masked rows
        to the NULL block. Returns ``(out, last_tokens, paged, remaining')``;
        the pools and ``paged.lengths`` are updated in place."""
        if self.decode_mode == "mega":
            def step(tok, lens, act):
                logits, _, _ = self.model.decode_mega_paged(
                    self._mega_paged_step, self._mega_layers, tok, paged.k, paged.v, paged.tables,
                    lens, act)
                return logits

            out, token, lengths, rem = self._decode_loop(step, tokens, remaining, paged.lengths, chunk,
                                                         generator)
            paged.lengths.copy_(lengths)
            return out, token, paged, rem
        lengths0 = paged.lengths.clone()
        remaining0 = torch.as_tensor(remaining, device=self.device).to(torch.int32)
        cache = KVCache(k=gather_paged_kv(paged.k, paged.tables), v=gather_paged_kv(paged.v, paged.tables),
                        lengths=lengths0.clone())
        out, token, cache, rem = self.decode_steps(cache, tokens, remaining0, chunk, generator)
        _scatter_chunk(paged, cache, lengths0, remaining0, chunk)
        paged.lengths.copy_(cache.lengths)
        return out, token, paged, rem

    def spec_decode_steps_paged(self, paged: PagedKVCache, dstate, tokens, remaining, chunk: int, k: int):
        """Speculative twin of ``decode_steps_paged``: not ported yet."""
        raise NotImplementedError(SPECULATIVE)

    # ----------------------------------------------------------------- serve
    @torch.no_grad()
    def serve(self, input_ids, gen_len: int, generator: torch.Generator | None = None):
        """Generate ``gen_len`` tokens per row of ``input_ids`` (B, S):
        prefill, pad the caches to ``max_len``, then ``gen_len - 1`` decode
        steps. Returns (B, gen_len) int32 on the model's device."""
        ids = torch.as_tensor(input_ids, device=self.device)
        bsz, seq = ids.shape
        if seq + gen_len > self.max_len:
            raise ValueError(f"{seq} + {gen_len} tokens exceed max_len={self.max_len}")
        logits, (ks, vs) = self.model.prefill(ids, mode=self.prefill_mode)
        cache = self._make_cache(ks, vs, seq)
        token = self._sample(logits, generator)
        out = torch.empty((bsz, gen_len), dtype=torch.int32, device=self.device)
        out[:, 0] = token
        lengths = cache.lengths.clone()
        for i in range(1, gen_len):
            token = self._sample(self._decode(token, cache, lengths), generator)
            out[:, i] = token
            lengths += 1
        # gen_len - 1 decode steps each wrote their input token's KV; the
        # last generated token's KV is not written yet.
        self.kv_cache = KVCache(k=cache.k, v=cache.v, lengths=cache.lengths + gen_len - 1)
        return out


def _scatter_chunk(paged: PagedKVCache, cache: KVCache, lengths0: torch.Tensor,
                   remaining0: torch.Tensor, chunk: int) -> None:
    """Write a decode chunk's contiguous rows back into the pool: row r of
    slot b landed at ``lengths0[b] + r`` (capped at the last row) and is real
    while ``r < remaining0[b]``; masked rows go to the NULL block."""
    bs = paged.block_size
    smax = cache.k.shape[3]
    nv = remaining0.clamp(0, chunk)
    rows = torch.arange(paged.tables.shape[0], device=lengths0.device)
    for r in range(chunk):
        pos = (lengths0 + r).clamp(max=smax - 1).long()
        blk = torch.gather(paged.tables, 1, (pos // bs)[:, None])[:, 0].long()
        phys = torch.where(r < nv, blk, torch.full_like(blk, NULL_BLOCK))
        sub = pos % bs
        paged.k[:, phys, :, sub] = cache.k[:, rows, :, pos]
        paged.v[:, phys, :, sub] = cache.v[:, rows, :, pos]
