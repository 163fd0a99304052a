"""Inference engine at world 1: counterpart of ``triton_dist_tpu/models/engine.py``
(``sample_token``, ``Engine.serve``, ``alloc_slots``, ``prefill_into_slot``,
``decode_steps``).

PyTorch runs eagerly, so where JAX jit-compiles one program per shape and
loops on the device with ``fori_loop``, this engine calls the model step by
step from a Python loop (CUDA graphs are later work). The model is a
``DenseLLM`` or a ``Qwen3MoE``; the engine does not look at its MLP. The
backends ``xla``, ``dist`` and ``dist_ar`` are ported (at world 1 the
dense layers compute the same in each; the MoE layers' ``xla`` mode uses
plain grouped GEMMs), ``mega`` is not. Caches are updated in place.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.models.dense import DenseLLM
from triton_dist_tpu_torch.models.kv_cache import KVCache

_BACKENDS = ("xla", "dist", "dist_ar", "mega")
PREFILL_MODE = {"xla": "xla", "dist": "dist", "dist_ar": "dist_ar"}
DECODE_MODE = {"xla": "xla", "dist": "dist_ar", "dist_ar": "dist_ar"}


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
        if backend == "mega":
            raise NotImplementedError("the mega backend is not ported yet (ROADMAP queue 1 item M)")
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
        self.kv_cache: KVCache | None = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _sample(self, logits, generator):
        return sample_token(logits, generator, self.sample_method, self.temperature, self.top_p)

    def _decode(self, token, cache: KVCache, lengths):
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

    def decode_steps(self, cache: KVCache, tokens, remaining, chunk: int,
                     generator: torch.Generator | None = None):
        """``chunk`` decode steps over the slot batch with a per-slot active
        mask (``remaining > 0``): inactive slots re-feed their last token,
        emit -1 and keep their lengths frozen. Returns ``(out (B, chunk)
        int32, last_tokens (B,), cache, remaining')``; ``cache`` is updated
        in place."""
        token = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        remaining = torch.as_tensor(remaining, device=self.device).to(torch.int32).clone()
        lengths = cache.lengths.clone()
        out = torch.full((token.shape[0], chunk), -1, dtype=torch.int32, device=self.device)
        for i in range(chunk):
            active = remaining > 0
            nxt = self._sample(self._decode(token, cache, lengths), generator)
            nxt = torch.where(active, nxt, token)
            out[:, i] = torch.where(active, nxt, torch.full_like(nxt, -1))
            step = active.to(torch.int32)
            lengths += step
            remaining -= step
            token = nxt
        cache.lengths.copy_(lengths)
        return out, token, cache, remaining

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
