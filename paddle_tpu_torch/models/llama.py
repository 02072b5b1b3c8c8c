"""Llama in PyTorch: training and serving decode.

Counterpart of ``paddle_tpu/models/llama.py``:

- the configuration;
- the training half (reference lines 94-285): ``LlamaAttention`` (GQA,
  RoPE, flash attention through the gate, or with
  ``context_parallel="ring"`` the ring over the mesh's ``sep`` axis),
  ``LlamaMLP`` (SwiGLU),
  ``LlamaDecoderLayer`` (pre-norm residual blocks, optional recompute),
  ``LlamaModel`` and ``LlamaForCausalLM`` (untied or tied head, the
  cross-entropy loss), with the reference's parameter names, ``[in, out]``
  weight layout and initializers, trained by torch autograd;
- the functional single-token decode (``decode_weights`` ..
  ``decode_step``, reference lines 299-526) that both the dense greedy
  generator and the paged serving engine run. Projections of an int8
  engine go through :func:`decode_matmul` to the int8 kernel; every other
  product stays ``torch.matmul``, as the reference leaves them to its
  compiler.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import random as R
from ..device import resolve_device
from ..distributed.fleet.sequence_parallel import ring_context_attention
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..nn import functional as F
from ..nn.functional.norm import rms_norm_composed
from ..nn.layer import Embedding, Linear, RMSNorm
from ..ops.quant_matmul import int8_matmul

__all__ = [
    "LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
    "LlamaForCausalLM", "load_reference_state_dict",
    "LlamaGreedyGenerator", "DenseDecodeKV",
    "decode_weights", "quantize_decode_weights", "weights_from_numpy", "map_weights",
    "decode_matmul", "decode_rms", "rope_tables", "rope_rotate",
    "masked_attend", "decode_step", "resolve_device",
]

_PROJ = ("q", "k", "v", "o", "gate", "up", "down")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    use_flash_attention: bool = True
    recompute: bool = False
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    sequence_parallel: bool = False
    context_parallel: str | None = None

    @staticmethod
    def llama3_8b(**overrides):
        cfg = LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0,
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    @staticmethod
    def tiny(**overrides):
        cfg = LlamaConfig(
            vocab_size=1024, hidden_size=256, intermediate_size=688,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
            max_position_embeddings=512,
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


# ---------------------------------------------------------------------------
# training half
# ---------------------------------------------------------------------------


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        hidden, kv = config.hidden_size, self.num_kv_heads * self.head_dim
        mk = dict(bias_attr=False, device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(hidden, hidden, **mk)
        self.k_proj = Linear(hidden, kv, **mk)
        self.v_proj = Linear(hidden, kv, **mk)
        self.o_proj = Linear(hidden, hidden, **mk)

    def forward(self, hidden_states, attention_mask=None, position_ids=None,
                past_key_value=None):
        """hidden_states [b, s, hidden]; RoPE over ``arange(s)`` (the
        reference does not read ``position_ids``); causal flash attention
        through the gate without a mask, the composed path with one. With
        ``context_parallel="ring"``, causal ring attention over the current
        mesh's ``sep`` axis (reference lines 134-148): RoPE stays on the
        global positions, since the ring's ranks live in this process."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k, _ = fused_rotary_position_embedding(q, k, None,
                                                  rotary_emb_base=self.config.rope_theta)
        if past_key_value is not None:
            k = torch.cat([past_key_value[0], k], dim=1)
            v = torch.cat([past_key_value[1], v], dim=1)
        causal = past_key_value is None
        if self.config.context_parallel == "ring":
            if attention_mask is not None:
                raise ValueError(
                    "context_parallel='ring' computes pure causal attention; "
                    "padding attention_mask is not supported on the ring path")
            if past_key_value is not None:
                raise ValueError(
                    "context_parallel='ring' is a training-time schedule; cached decode "
                    "(past_key_value) is not supported; export the model without "
                    "context_parallel for generation")
            out = ring_context_attention(q, k, v, causal=True)
            return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if self.config.use_flash_attention and attention_mask is None:
            out, _ = F.flash_attention(q, k, v, causal=causal, training=self.training)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attention_mask,
                is_causal=causal and attention_mask is None, training=self.training)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        mk = dict(bias_attr=False, device=device, dtype=dtype, generator=generator)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size, **mk)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size, **mk)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size, **mk)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        mk = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = LlamaAttention(config, **mk)
        self.mlp = LlamaMLP(config, **mk)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                                device=device, dtype=dtype)
        self._recompute = config.recompute

    def _inner(self, hidden_states, attention_mask=None, position_ids=None):
        residual = hidden_states
        hidden_states = self.input_layernorm(hidden_states)
        hidden_states = self.self_attn(hidden_states, attention_mask, position_ids)
        hidden_states = residual + hidden_states
        residual = hidden_states
        hidden_states = self.post_attention_layernorm(hidden_states)
        return residual + self.mlp(hidden_states)

    def forward(self, hidden_states, attention_mask=None, position_ids=None):
        """With ``config.recompute`` in training, the block's activations
        are recomputed in the backward (``torch.utils.checkpoint``)."""
        if self._recompute and self.training:
            return checkpoint(self._inner, hidden_states, attention_mask, position_ids,
                              use_reentrant=False)
        return self._inner(hidden_states, attention_mask, position_ids)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, device=device,
                                      dtype=dtype, generator=generator)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device=device, dtype=dtype, generator=generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device=device,
                            dtype=dtype)

    def forward(self, input_ids, attention_mask=None, position_ids=None):
        hidden_states = self.embed_tokens(input_ids)
        for layer in self.layers:
            hidden_states = layer(hidden_states, attention_mask, position_ids)
        return self.norm(hidden_states)


class LlamaForCausalLM(nn.Module):
    """Llama with the reference's parameter names and shapes:
    ``llama.embed_tokens.weight`` ``[vocab, hidden]``,
    ``llama.layers.{i}.self_attn.{q,k,v,o}_proj.weight`` and
    ``mlp.{gate,up,down}_proj.weight`` ``[in, out]``,
    ``input_layernorm``/``post_attention_layernorm``/``llama.norm``
    ``[hidden]``, and an untied ``lm_head.weight`` ``[hidden, vocab]`` (a
    tied head multiplies by the embedding's transpose).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's initializers (Xavier-uniform
    projections, N(0, 1) embedding, ones for norms). They are trainable;
    serving reads them through :func:`decode_weights` under ``no_grad``.
    Tests carry the reference's weights across with
    :func:`load_reference_state_dict` or :meth:`load_decode_weights`.
    """

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        if config.moe_num_experts > 0:
            raise NotImplementedError(
                "MoE decoders wait for the distributed slice of the port")
        if config.sequence_parallel or config.context_parallel not in (None, "ring"):
            raise NotImplementedError(
                "sequence parallelism and context parallelism other than the ring wait "
                "for the distributed slice of the port")
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.llama = LlamaModel(config, device=dev, dtype=dtype, generator=gen)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size, bias_attr=False,
                               device=dev, dtype=dtype, generator=gen))

    def forward(self, input_ids, attention_mask=None, position_ids=None, labels=None):
        """input_ids [b, s] -> logits [b, s, vocab]; with ``labels`` [b, s],
        ``(loss, logits)`` where loss is the mean cross entropy (f32)."""
        hidden_states = self.llama(input_ids, attention_mask, position_ids)
        if self.lm_head is None:
            logits = torch.matmul(hidden_states, self.llama.embed_tokens.weight.T)
        else:
            logits = self.lm_head(hidden_states)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), reduction="mean")
        return loss, logits

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (forward and backward,
        ``6 N + 12 L hidden seq``), as the reference counts them."""
        c = self.config
        return 6.0 * self.num_params() + 12 * c.num_hidden_layers * c.hidden_size * seq_len

    @torch.no_grad()
    def load_decode_weights(self, w: dict) -> "LlamaForCausalLM":
        """Copy a :func:`decode_weights`-shaped tree (tensors of matching
        shapes, e.g. from :func:`weights_from_numpy`) into the
        parameters."""
        m = self.llama
        m.embed_tokens.weight.copy_(w["embed"])
        m.norm.weight.copy_(w["norm"])
        if self.lm_head is not None:
            self.lm_head.weight.copy_(w["lm_head"])
        for lyr, lw in zip(m.layers, w["layers"], strict=True):
            lyr.input_layernorm.weight.copy_(lw["input_ln"])
            lyr.post_attention_layernorm.weight.copy_(lw["post_ln"])
            for p, mod in zip(_PROJ, _projections(lyr)):
                mod.weight.copy_(lw[p])
        return self


def _projections(lyr):
    a, f = lyr.self_attn, lyr.mlp
    return (a.q_proj, a.k_proj, a.v_proj, a.o_proj,
            f.gate_proj, f.up_proj, f.down_proj)


@torch.no_grad()
def load_reference_state_dict(model: nn.Module, state: dict) -> nn.Module:
    """Load ``{key: array}`` (the reference's ``model.state_dict()`` read as
    numpy) into ``model`` by key, each array cast to its parameter's dtype
    and moved to its device. A key that is missing or extra, or a shape that
    differs, raises."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, extra {extra}")
    for key, target in own.items():
        arr = torch.as_tensor(np.array(state[key]))
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(target.shape)}")
        target.copy_(arr.to(dtype=target.dtype, device=target.device))
    return model


# ---------------------------------------------------------------------------
# functional single-token decode
# ---------------------------------------------------------------------------


def decode_weights(model: LlamaForCausalLM) -> dict:
    """Weight tree for :func:`decode_step` (the reference's layout):
    ``{"embed", "norm", "lm_head" (None when tied), "layers": [{"input_ln",
    "post_ln", "q", "k", "v", "o", "gate", "up", "down"}]}``, tensors
    shared with the module."""
    m = model.llama
    return {
        "embed": m.embed_tokens.weight.detach(),
        "norm": m.norm.weight.detach(),
        "lm_head": None if model.lm_head is None else model.lm_head.weight.detach(),
        "layers": [
            {"input_ln": lyr.input_layernorm.weight.detach(),
             "post_ln": lyr.post_attention_layernorm.weight.detach(),
             **{p: mod.weight.detach() for p, mod in zip(_PROJ, _projections(lyr))}}
            for lyr in m.layers
        ],
    }


def map_weights(tree: dict, fn) -> dict:
    """Apply ``fn`` to every array of a :func:`decode_weights` tree
    (including the ``qw``/``scale`` of quantized leaves); a missing
    ``lm_head`` stays None."""
    def leaf(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: leaf(v) for k, v in a.items()}
        return fn(a)

    return {"embed": leaf(tree["embed"]), "norm": leaf(tree["norm"]),
            "lm_head": leaf(tree["lm_head"]),
            "layers": [{k: leaf(v) for k, v in lw.items()} for lw in tree["layers"]]}


def weights_from_numpy(tree, device="cuda", dtype=None):
    """A :func:`decode_weights` tree of numpy arrays (e.g. the reference's
    ``decode_weights(model)`` read with ``np.asarray``) as torch tensors
    on ``device``; floating arrays are cast to ``dtype`` when given.
    Quantized ``{"qw", "scale"}`` leaves keep their int8/f32 types."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.tensor(np.asarray(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return map_weights(tree, leaf)


def _quantize(mat: torch.Tensor) -> dict:
    a = mat.float()
    amax = a.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qw = torch.clamp(torch.round(a / scale[None, :]), -127, 127).to(torch.int8)
    return {"qw": qw.contiguous(), "scale": scale.contiguous()}


@torch.no_grad()
def quantize_decode_weights(w: dict) -> dict:
    """Int8 weight-only quantization of a :func:`decode_weights` tree:
    every 2-D projection (the seven per-layer mats and an untied
    ``lm_head``) becomes ``{"qw": int8 [K, N], "scale": f32 [N]}`` with
    symmetric per-output-channel scales ``amax / 127`` (1 for an all-zero
    column) and round-half-to-even, bit-identical to the reference's host
    numpy quantizer. Runs on the weights' device. Embedding, norms and a
    tied head stay as they are."""
    return {
        "embed": w["embed"],
        "norm": w["norm"],
        "lm_head": None if w["lm_head"] is None else _quantize(w["lm_head"]),
        "layers": [
            {"input_ln": lw["input_ln"], "post_ln": lw["post_ln"],
             **{p: _quantize(lw[p]) for p in _PROJ}}
            for lw in w["layers"]
        ],
    }


def decode_matmul(x, w):
    """``x @ w`` where ``w`` is a tensor or a quantized ``{"qw", "scale"}``
    leaf; quantized leaves go to the int8 kernel with x's leading dims
    flattened."""
    if not isinstance(w, dict):
        return x @ w
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]), w["qw"], w["scale"])
    return out.reshape(*lead, out.shape[-1])


#: the decode path's RMSNorm: the composed form (f32 statistics, cast back
#: before the weight), as the reference's ``decode_rms``
decode_rms = rms_norm_composed


def rope_tables(pos, theta, head_dim):
    """(sin, cos) of neox-half rotary angles in f32, with a trailing
    ``[head_dim / 2]`` axis appended to ``pos``'s shape."""
    pos = torch.as_tensor(pos)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=pos.device) / head_dim))
    ang = pos.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def rope_rotate(x, sin, cos):
    """Neox-half rotation; sin/cos broadcast against ``x[..., :half]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def masked_attend(q, kc, vc, visible):
    """One query per lane over a (GQA) cache window. q [b, H, hd];
    kc/vc [b, S, Hk, hd]; visible [b|1, S] bool. Logits scaled by
    1/sqrt(hd), softmax in f32, probabilities cast to q's dtype before the
    weighted sum. Returns [b, H, hd]."""
    H, hd = q.shape[1], q.shape[2]
    rep = H // kc.shape[2]
    kfull = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
    vfull = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bhd,bshd->bhs", q, kfull).float() * scale
    logits = logits.masked_fill(~visible[:, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", probs, vfull)


class DenseDecodeKV:
    """Dense per-lane caches ``[b, max_len, Hk, hd]`` per layer, written in
    place at one shared position."""

    def __init__(self, caches, pos: int, max_len: int):
        self.caches = caches
        self.pos = int(pos)
        self.max_len = int(max_len)

    def append(self, li, k, v):
        kc, vc = self.caches[li]
        kc[:, self.pos] = k
        vc[:, self.pos] = v

    def attend(self, li, q):
        kc, vc = self.caches[li]
        visible = (torch.arange(self.max_len, device=q.device) <= self.pos)[None, :]
        return masked_attend(q, kc, vc, visible)


def decode_step(config: LlamaConfig, w: dict, tok, kv, pos):
    """One-token decode for a batch of lanes. tok [b] int token per lane;
    pos [b] int write/rope position per lane; kv a cache adapter
    (``append(li, k, v)`` then ``attend(li, q)``). Returns logits
    [b, vocab]."""
    cfg = config
    H = cfg.num_attention_heads
    Hk = cfg.num_key_value_heads
    hd = cfg.hidden_size // H
    h = w["embed"][tok.long()][:, None, :]
    b = h.shape[0]
    sin, cos = rope_tables(pos, cfg.rope_theta, hd)
    sin, cos = sin[:, None, :], cos[:, None, :]
    for li, lw in enumerate(w["layers"]):
        x = decode_rms(h, lw["input_ln"], cfg.rms_norm_eps)
        q = decode_matmul(x, lw["q"]).reshape(b, H, hd)
        k = decode_matmul(x, lw["k"]).reshape(b, Hk, hd)
        v = decode_matmul(x, lw["v"]).reshape(b, Hk, hd)
        q, k = rope_rotate(q, sin, cos), rope_rotate(k, sin, cos)
        kv.append(li, k, v)
        out = kv.attend(li, q).reshape(b, 1, H * hd)
        h = h + decode_matmul(out, lw["o"])
        x = decode_rms(h, lw["post_ln"], cfg.rms_norm_eps)
        h = h + decode_matmul(
            torch.nn.functional.silu(decode_matmul(x, lw["gate"]))
            * decode_matmul(x, lw["up"]), lw["down"])
    h = decode_rms(h, w["norm"], cfg.rms_norm_eps)
    if w["lm_head"] is None:
        return h[:, 0, :] @ w["embed"].T
    return decode_matmul(h[:, 0, :], w["lm_head"])


class LlamaGreedyGenerator:
    """Decoding over dense caches, one token per step for prompt and
    generation alike: the oracle the serving engine is held against.
    Lanes that emit ``eos_token_id`` keep writing it; the loop stops when
    every lane has finished or ``max_len`` is reached. Greedy argmax, or
    with ``do_sample`` temperature, top-k and top-p sampling from one
    threefry key ``PRNGKey(seed)`` split once a step, as the reference's
    ``_pick_token``."""

    def __init__(self, model: LlamaForCausalLM, max_len: int,
                 eos_token_id: int | None = None, do_sample: bool = False,
                 top_k: int = 0, top_p: float = 1.0, temperature: float = 1.0,
                 seed: int = 0):
        self.model = model
        self.max_len = int(max_len)
        self.eos_token_id = -1 if eos_token_id is None else int(eos_token_id)
        self.do_sample = bool(do_sample)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        self.seed = int(seed)

    def _pick_token(self, logits, key):
        """logits [b, V] -> (token [b], new key): the top-k and top-p
        filter of :func:`paddle_tpu_torch.random.filter_logits` with this
        generator's settings on every row; the draw is ``categorical`` over
        the whole [b, V] under the step's split key."""
        if not self.do_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), key
        lg = logits.float() / max(self.temperature, 1e-6)
        rows = (lg.shape[0],)
        lg = R.filter_logits(
            lg, torch.full(rows, self.top_k, device=lg.device),
            torch.full(rows, self.top_p, dtype=torch.float32, device=lg.device))
        key, sub = R.split(key)
        return R.categorical(sub, lg).to(torch.int32), key

    @torch.no_grad()
    def __call__(self, input_ids, prompt_len):
        """input_ids [b, P] right-padded prompts; prompt_len [b]. Returns
        (ids [b, max_len] int32, gen_len [b] int32)."""
        cfg = self.model.config
        w = decode_weights(self.model)
        dev = w["embed"].device
        ids0 = torch.as_tensor(np.asarray(input_ids), dtype=torch.int32, device=dev)
        plen = torch.as_tensor(np.asarray(prompt_len), dtype=torch.int32, device=dev)
        b = ids0.shape[0]
        hk = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        dtype = w["embed"].dtype
        ids = torch.zeros((b, self.max_len), dtype=torch.int32, device=dev)
        ids[:, :ids0.shape[1]] = ids0
        caches = [(torch.zeros((b, self.max_len, hk, hd), dtype=dtype, device=dev),
                   torch.zeros((b, self.max_len, hk, hd), dtype=dtype, device=dev))
                  for _ in range(cfg.num_hidden_layers)]
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        flen = torch.zeros((b,), dtype=torch.int32, device=dev)
        eos = torch.tensor(self.eos_token_id, dtype=torch.int32, device=dev)
        key = R.prng_key(self.seed, device=dev)
        pos = 0
        while pos < self.max_len - 1 and not bool(finished.all()):
            tok = ids[:, pos]
            kv = DenseDecodeKV(caches, pos, self.max_len)
            logits = decode_step(cfg, w, tok, kv,
                                 torch.full((b,), pos, dtype=torch.int32, device=dev))
            nxt, key = self._pick_token(logits, key)
            in_prompt = (pos + 1) < plen
            tok_next = torch.where(in_prompt, ids[:, pos + 1],
                                   torch.where(finished, eos, nxt))
            fin_next = finished | (~in_prompt & (tok_next == eos))
            flen = torch.where(fin_next & ~finished, pos + 2, flen)
            finished = fin_next
            ids[:, pos + 1] = tok_next
            pos += 1
        gen_len = torch.where(finished, flen, torch.full_like(flen, pos + 1))
        return ids, gen_len
