"""ERNIE encoders in PyTorch (counterpart of ``paddle_tpu/models/ernie.py``).

The configuration (ERNIE-3.0 base defaults, ``tiny()`` for tests), the
embeddings (word + position + token type, optionally task type, then
LayerNorm and dropout), the post-LN ``nn.TransformerEncoder`` with GELU
feed-forward blocks, the pooler (``tanh(dense(CLS))``) and four heads:
sequence and token classification, question answering (start and end
logits) and the masked LM, whose decoder is tied to the word embedding.

The modules keep the reference's parameter names and ``[in, out]``
layouts, so its ``state_dict`` read as numpy loads by key
(:func:`load_reference_state_dict`). The reference's ``state_dict`` lists
a parameter once, so the masked LM's tied decoder (``cls._tied``, the
same ``Parameter`` as ``ernie.embeddings.word_embeddings.weight``) has no
key of its own there; the loader follows that.

Each model owns one ``torch.Generator`` (``model.generator``, on the
model's device, seeded with ``seed``): it draws the initial weights
(N(0, 1) embeddings, Xavier-uniform projections, as the reference's
initializers) and then every dropout mask of the model, one stream for
all its layers. Set its state to repeat a step's masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear, TransformerEncoder,
                        TransformerEncoderLayer)
from ._weights import load_reference_state_dict

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErniePooler", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieForQuestionAnswering", "ErnieLMPredictionHead", "ErnieForMaskedLM",
           "load_reference_state_dict"]


@dataclass
class ErnieConfig:
    """PaddleNLP's ``ErnieConfig`` defaults for ernie-3.0-base-zh."""

    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 0   # > 0 adds the task-type embeddings
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @staticmethod
    def tiny(**overrides):
        """2 layers, hidden 32, 4 heads, FFN 64, vocab 128, no dropout."""
        cfg = ErnieConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    @staticmethod
    def base(**overrides):
        """ERNIE-3.0 base: vocab 40000, hidden 768, 12 layers, 12 heads, FFN
        3072, 2048 positions, dropout 0.1."""
        cfg = ErnieConfig()
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


class ErnieEmbeddings(nn.Module):
    """word + position + token type (+ task type) embeddings, LayerNorm,
    dropout."""

    def __init__(self, cfg: ErnieConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                             **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.task_type_embeddings = (
            Embedding(cfg.task_type_vocab_size, cfg.hidden_size, **kw)
            if cfg.task_type_vocab_size else None)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, task_type_ids=None):
        """Positions default to ``arange(seq)`` for every row, token and task
        types to zeros."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = emb + self.token_type_embeddings(token_type_ids)
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            emb = emb + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErniePooler(nn.Module):
    """``tanh(dense(hidden_states[:, 0]))``: the CLS token's state."""

    def __init__(self, hidden_size, *, device, dtype, generator):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device, dtype=dtype,
                            generator=generator)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class ErnieModel(nn.Module):
    """Embeddings, then the post-LN ``nn.TransformerEncoder`` (GELU
    feed-forward), then the pooler: ``(sequence_output [B, S, H],
    pooled_output [B, H])``.

    ``attention_mask`` is ``[B, S]``, 1 for a real token and 0 for padding
    (PaddleNLP's convention); without it the tokens equal to
    ``pad_token_id`` are masked. Either becomes an additive f32 mask
    ``[B, 1, 1, S]``: 0 to attend, -1e9 not to."""

    def __init__(self, config: ErnieConfig, *, device="cuda", dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=self.generator)
        self.embeddings = ErnieEmbeddings(config, **kw)
        enc_layer = TransformerEncoderLayer(
            d_model=config.hidden_size, nhead=config.num_attention_heads,
            dim_feedforward=config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act, attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False, layer_norm_eps=config.layer_norm_eps,
            **kw)
        self.encoder = TransformerEncoder(enc_layer, config.num_hidden_layers)
        self.pooler = ErniePooler(config.hidden_size, **kw)

    def _additive_mask(self, input_ids, attention_mask):
        if attention_mask is None:
            keep = input_ids != self.config.pad_token_id
        else:
            keep = attention_mask.bool()
        return torch.where(keep[:, None, None, :], 0.0, -1e9).to(torch.float32)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None,
                task_type_ids=None):
        mask = self._additive_mask(input_ids, attention_mask)
        emb = self.embeddings(input_ids, token_type_ids, position_ids, task_type_ids)
        sequence_output = self.encoder(emb, mask)
        return sequence_output, self.pooler(sequence_output)


class _Head(nn.Module):
    """An :class:`ErnieModel` and a linear ``classifier`` on its states,
    drawn from the model's generator."""

    def __init__(self, config, num_classes, device, dtype, seed):
        super().__init__()
        self.ernie = ErnieModel(config, device=device, dtype=dtype, seed=seed)
        self.classifier = Linear(config.hidden_size, num_classes, device=self.generator.device,
                                 dtype=dtype, generator=self.generator)

    @property
    def generator(self) -> torch.Generator:
        return self.ernie.generator


class ErnieForSequenceClassification(_Head):
    """The finetune head: the pooled CLS state, dropout, then
    ``classifier [hidden, num_classes]``."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2, dropout=None, *,
                 device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__(config, num_classes, device, dtype, seed)
        self.dropout = Dropout(config.hidden_dropout_prob if dropout is None else dropout,
                               generator=self.generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForTokenClassification(_Head):
    """Per-token logits ``[B, S, num_classes]``."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2, dropout=None, *,
                 device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__(config, num_classes, device, dtype, seed)
        self.dropout = Dropout(config.hidden_dropout_prob if dropout is None else dropout,
                               generator=self.generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        return self.classifier(self.dropout(seq))


class ErnieForQuestionAnswering(_Head):
    """Span logits: ``(start [B, S], end [B, S])``."""

    def __init__(self, config: ErnieConfig, *, device="cuda", dtype=torch.float32,
                 seed: int = 0):
        super().__init__(config, 2, device, dtype, seed)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        start, end = self.classifier(seq).unbind(-1)
        return start, end


class ErnieLMPredictionHead(nn.Module):
    """The MLM head: ``transform``, the activation, ``layer_norm``, then the
    product with the word embedding ``[vocab, hidden]`` transposed (held as
    ``_tied``: the same ``Parameter``, so one tensor gets both gradients
    and one update) plus ``decoder_bias [vocab]`` (zeros)."""

    def __init__(self, config: ErnieConfig, embedding_weights, *, device, dtype, generator):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size, device=device,
                                dtype=dtype, generator=generator)
        self.activation = getattr(F, config.hidden_act)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self._tied = embedding_weights
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size, device=device,
                                                     dtype=dtype))

    def forward(self, hidden_states):
        h = self.layer_norm(self.activation(self.transform(hidden_states)))
        return F.linear(h, self._tied.T) + self.decoder_bias


class ErnieForMaskedLM(nn.Module):
    """The masked LM: vocabulary logits ``[B, S, vocab]`` from a decoder
    tied to the word embedding."""

    def __init__(self, config: ErnieConfig, *, device="cuda", dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        self.ernie = ErnieModel(config, device=device, dtype=dtype, seed=seed)
        gen = self.ernie.generator
        self.cls = ErnieLMPredictionHead(config, self.ernie.embeddings.word_embeddings.weight,
                                         device=gen.device, dtype=dtype, generator=gen)

    @property
    def generator(self) -> torch.Generator:
        return self.ernie.generator

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        return self.cls(seq)
