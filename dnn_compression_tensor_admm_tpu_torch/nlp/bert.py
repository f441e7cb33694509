"""BERT, dense and compressed (counterpart of the JAX package's
`nlp/bert.py`; the reference's xcompression/transformer/modeling.py and
its compressed_modeling* variants).

Parameter names are the BERT state dict's, and the JAX package's flax
paths joined by dots ('bert.encoder.layer.0.attention.self.query.weight');
`utils/jax_weights.py` carries them across. One parameter per flax leaf:
no fused QKV, since BertAdam clips each gradient by its own norm. A
`BertCompressionPlan` swaps every encoder linear for a TT or SVD layer,
ranks solved from a ratio, and the word embedding for an SVD, TT or
Kronecker embedding. The outputs hold every hidden state (the embedding
output first) and every layer's pre-softmax attention scores, which the
two-stage distillation reads.

Numerics as the JAX package's float32 modules: scores in float32 with an
additive -1e9 mask, exact GELU, LayerNorm eps 1e-12, the pooler and the
QA head in float32. Dropout draws from the generator given to `forward`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SVDLinear, TTLinear
from .factorization import svd_spec_from_ratio, tt_linear_spec_from_ratio
from .initializers import normal_, xavier_uniform_
from .ket_embedding import KetEmbedding, KetXSEmbedding
from .svd_embedding import SVDEmbedding
from .tt_embedding import TTEmbedding


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class BertCompressionPlan:
    """Ratio-driven compression of a BERT encoder.

    linear_format: 'tt' | 'svd' | None, for the six encoder linears of a
    layer (query, key, value, attention output, intermediate, output).
    embedding_format: 'svd' | 'tt' | 'ket' | 'ketxs' | None, for the word
    embedding ('ket'/'ketxs' are word2ket Kronecker embeddings).
    """
    linear_format: Optional[str] = None
    linear_ratio: float = 2.0
    tt_dim: int = 2
    embedding_format: Optional[str] = None
    embedding_ratio: float = 4.0
    embedding_order: int = 4  # ket/ketxs Kronecker order


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scaled by its
    inverse; the mask from `generator`."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def dense(in_f: int, out_f: int, generator=None) -> nn.Linear:
    """flax `nn.Dense` with the BERT init: weight N(0, 0.02), bias 0."""
    lin = nn.Linear(in_f, out_f)
    normal_(lin.weight, 0.02, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _linear(plan: Optional[BertCompressionPlan], in_f: int, out_f: int,
            generator=None) -> nn.Module:
    if plan is None or plan.linear_format is None:
        return dense(in_f, out_f, generator)
    if plan.linear_format == "tt":
        spec = tt_linear_spec_from_ratio(in_f, out_f, plan.linear_ratio,
                                         plan.tt_dim)
        layer = TTLinear(in_f, out_f, spec)
        factors = [getattr(layer, f"core_{i}") for i in range(layer.n_cores)]
    elif plan.linear_format == "svd":
        layer = SVDLinear(in_f, out_f, svd_spec_from_ratio(
            in_f, out_f, plan.linear_ratio))
        factors = [layer.first_factor, layer.last_factor]
    else:
        raise ValueError(plan.linear_format)
    for f in factors:  # flax's xavier fans
        xavier_uniform_(f, generator)
    return layer


def _word_embedding(c: BertConfig, plan: Optional[BertCompressionPlan],
                    generator) -> nn.Module:
    fmt = plan.embedding_format if plan is not None else None
    v, d = c.vocab_size, c.hidden_size
    if fmt == "svd":
        return SVDEmbedding(v, d, compression_ratio=plan.embedding_ratio,
                            generator=generator)
    if fmt == "tt":
        return TTEmbedding(v, d, compression_ratio=plan.embedding_ratio,
                           generator=generator)
    if fmt == "ket":
        return KetEmbedding(v, d, order=plan.embedding_order,
                            compression_ratio=plan.embedding_ratio,
                            generator=generator)
    if fmt == "ketxs":
        return KetXSEmbedding(v, d, order=plan.embedding_order,
                              compression_ratio=plan.embedding_ratio,
                              generator=generator)
    if fmt is not None:
        raise ValueError(fmt)
    return _table(v, d, generator)


def _table(n: int, d: int, generator) -> nn.Embedding:
    emb = nn.Embedding(n, d)
    normal_(emb.weight, 0.02, generator)
    return emb


def layer_norm(c: BertConfig) -> nn.LayerNorm:
    return nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig,
                 plan: Optional[BertCompressionPlan] = None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = _word_embedding(cfg, plan, generator)
        self.position_embeddings = _table(cfg.max_position, cfg.hidden_size,
                                          generator)
        self.token_type_embeddings = _table(cfg.type_vocab_size,
                                            cfg.hidden_size, generator)
        self.LayerNorm = layer_norm(cfg)

    def forward(self, input_ids, token_type_ids, generator=None):
        n = input_ids.shape[-1]
        y = (self.word_embeddings(input_ids)
             + self.position_embeddings.weight[None, :n]
             + self.token_type_embeddings(token_type_ids))
        return dropout(self.LayerNorm(y), self.cfg.dropout, self.training,
                       generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig,
                 plan: Optional[BertCompressionPlan] = None, generator=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.hidden_size, cfg.intermediate_size
        lin = lambda i, o: _linear(plan, i, o, generator)  # noqa: E731
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({"query": lin(d, d), "key": lin(d, d),
                                   "value": lin(d, d)}),
            "output": nn.ModuleDict({"dense": lin(d, d),
                                     "LayerNorm": layer_norm(cfg)})})
        self.intermediate = nn.ModuleDict({"dense": lin(d, ff)})
        self.output = nn.ModuleDict({"dense": lin(ff, d),
                                     "LayerNorm": layer_norm(cfg)})

    def forward(self, x, mask, generator=None):
        c = self.cfg
        h = c.num_heads
        b, n, d = x.shape
        hd = d // h
        att = self.attention["self"]

        def heads(t):
            return t.reshape(b, n, h, hd).transpose(1, 2)

        q, k, v = (heads(att[name](x)) for name in ("query", "key", "value"))
        scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        scores = scores.float() + mask                     # [B, h, N, N]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        probs = dropout(probs, c.attn_dropout, self.training, generator)
        ctx = (probs @ v).transpose(1, 2).reshape(b, n, d)
        out = self.attention["output"]
        att_out = dropout(out["dense"](ctx), c.dropout, self.training,
                          generator)
        x = out["LayerNorm"](x + att_out)
        inter = F.gelu(self.intermediate["dense"](x), approximate="none")
        y = dropout(self.output["dense"](inter), c.dropout, self.training,
                    generator)
        return self.output["LayerNorm"](x + y), scores


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig,
                 plan: Optional[BertCompressionPlan] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, plan, generator)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            BertLayer(cfg, plan, generator) for _ in range(cfg.num_layers))})
        self.pooler = nn.ModuleDict({"dense": dense(
            cfg.hidden_size, cfg.hidden_size, generator)})

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        y = self.embeddings(input_ids, token_type_ids, generator)
        hidden_states, attentions = [y], []
        for layer in self.encoder["layer"]:
            y, att = layer(y, mask, generator)
            hidden_states.append(y)
            attentions.append(att)
        pooled = torch.tanh(self.pooler["dense"](y[:, 0].float()))
        return {"sequence_output": y, "pooled_output": pooled,
                "hidden_states": hidden_states, "attentions": attentions}


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, num_labels: int = 2,
                 plan: Optional[BertCompressionPlan] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, plan, generator=generator)
        self.classifier = dense(cfg.hidden_size, num_labels, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        out = self.bert(input_ids, attention_mask, token_type_ids, generator)
        pooled = dropout(out["pooled_output"], self.cfg.dropout,
                         self.training, generator)
        out["logits"] = self.classifier(pooled)
        return out


class BertForQuestionAnswering(nn.Module):
    def __init__(self, cfg: BertConfig,
                 plan: Optional[BertCompressionPlan] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = BertModel(cfg, plan, generator=generator)
        self.qa_outputs = dense(cfg.hidden_size, 2, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        out = self.bert(input_ids, attention_mask, token_type_ids, generator)
        logits = self.qa_outputs(out["sequence_output"].float())
        out["start_logits"] = logits[..., 0]
        out["end_logits"] = logits[..., 1]
        return out
