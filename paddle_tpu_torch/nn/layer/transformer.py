"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention`` projects to ``[batch, seq, heads, head_dim]`` and
calls the port's ``F.scaled_dot_product_attention``, as the reference
does: with a mask (or dropout in training) that is the composed
attention, otherwise the flash gate. The encoder and decoder stacks are
deep copies of one layer, so every layer starts from the same weights, as
in the reference; the copies share the layer's random generators
(:func:`clones`), so their dropout layers draw different masks from one
stream.

Layers with parameters take ``device``, ``dtype`` and ``generator``
keywords: ``generator`` draws the initial weights (Xavier-uniform
projections; norms of ones and zeros) and then the dropout masks.
"""

from __future__ import annotations

import copy

import torch

from ...device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer", "clones"]


def clones(layer, n: int) -> list:
    """``n`` deep copies of ``layer`` that share its ``torch.Generator``s
    (``copy.deepcopy`` alone would give each copy a clone of each generator
    in the same state, and the copies would draw the same masks)."""
    shared = {id(m.generator): m.generator for m in layer.modules()
              if getattr(m, "generator", None) is not None}
    return [copy.deepcopy(layer, dict(shared)) for _ in range(n)]


class MultiHeadAttention(Layer):
    """Attention with ``q_proj``, ``k_proj``, ``v_proj`` (from ``kdim`` and
    ``vdim`` when given) and ``out_proj``, each ``[in, out]`` with a bias
    unless ``bias_attr=False``; ``dropout`` is the attention probabilities'
    (drawn from ``generator``) in training."""

    class Cache:
        """Keys and values so far ``[batch, seq, heads, head_dim]``; a step
        appends its own."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        """Keys and values computed once (cross attention's memory)."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)

    def _shape(self, x):
        """``[B, S, E]`` -> ``[B, S, H, D]``."""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        """``[B, S, E]`` -> ``[B, S, E]``; with a :class:`Cache`, ``(out,
        cache)`` whose keys and values end with this call's."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=self.dropout, training=self.training,
                                             generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1], self.embed_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """A :class:`StaticCache` of ``key`` / ``value``'s projections when
        ``type`` is ``StaticCache``, else an empty :class:`Cache`."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads, self.head_dim))
        return self.Cache(empty, empty.clone())


class TransformerEncoderLayer(Layer):
    """Self-attention then a feed-forward block (``linear1``, the
    activation named by ``activation`` in ``nn.functional``, ``linear2``),
    each in a residual with ``dropout``; post-LN, or pre-LN with
    ``normalize_before``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (:func:`clones`) in turn,
    then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(clones(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory``, then the
    feed-forward block, each in a residual; post-LN, or pre-LN with
    ``normalize_before``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (:func:`clones`) in turn,
    then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(clones(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """An encoder and a decoder stack (or the caller's ``custom_encoder`` /
    ``custom_decoder``); pre-LN stacks end in a ``LayerNorm``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, custom_encoder=None, custom_decoder=None, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout,
                act_dropout, normalize_before, weight_attr, bias_attr)
        kw = dict(device=device, dtype=dtype, generator=generator)

        def final_norm():
            return LayerNorm(d_model, device=device, dtype=dtype) if normalize_before else None

        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(TransformerEncoderLayer(*args, **kw),
                                              num_encoder_layers, final_norm())
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(TransformerDecoderLayer(*args, **kw),
                                              num_decoder_layers, final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device="cuda"):
        """``[length, length]`` f32: 0 on and below the diagonal, -inf above."""
        full = torch.full((length, length), float("-inf"), dtype=torch.float32,
                          device=resolve_device(device))
        return torch.triu(full, 1)
