"""Masked-LM training-shard pregeneration (a copy of the JAX package's
`nlp/pregenerate.py`: the same examples from the same seed; the reference's
xcompression/pregenerate_training_data.py:502): turn a raw text corpus
into fixed-length masked examples for general distillation.

Output: dict of int32 arrays {input_ids, attention_mask, token_type_ids,
masked_positions, masked_ids} — masking follows BERT's 80/10/10 rule.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .tokenization import WordPieceTokenizer, build_vocab_from_texts


def synthetic_corpus(n_docs: int = 64, seed: int = 0) -> List[str]:
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(300)]
    docs = []
    for _ in range(n_docs):
        n = rng.randint(20, 60)
        docs.append(" ".join(rng.choice(words, size=n)))
    return docs


def pregenerate_mlm_examples(texts: List[str],
                             tokenizer: Optional[WordPieceTokenizer] = None,
                             max_seq_length: int = 128,
                             masked_lm_prob: float = 0.15,
                             max_predictions: int = 20,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    if tokenizer is None:
        tokenizer = WordPieceTokenizer(build_vocab_from_texts(texts))
    rng = np.random.RandomState(seed)
    vocab_ids = [v for k, v in tokenizer.vocab.items()
                 if not k.startswith("[")]
    mask_id = tokenizer.vocab["[MASK]"]
    rows = {k: [] for k in ("input_ids", "attention_mask", "token_type_ids",
                            "masked_positions", "masked_ids")}
    for text in texts:
        ids, mask, types = tokenizer.encode_pair(text, None, max_seq_length)
        ids = np.asarray(ids, np.int32)
        n_real = int(np.sum(mask))
        cand = [i for i in range(1, n_real - 1)]  # skip [CLS]/[SEP]
        rng.shuffle(cand)
        n_mask = min(max_predictions, max(1, int(len(cand) * masked_lm_prob)))
        positions = sorted(cand[:n_mask])
        targets = ids[positions].copy()
        for p in positions:
            r = rng.rand()
            if r < 0.8:
                ids[p] = mask_id
            elif r < 0.9:
                ids[p] = rng.choice(vocab_ids)
            # else keep original (10%)
        pos_arr = np.full((max_predictions,), -1, np.int32)
        tgt_arr = np.full((max_predictions,), -1, np.int32)
        pos_arr[:n_mask] = positions
        tgt_arr[:n_mask] = targets
        rows["input_ids"].append(ids)
        rows["attention_mask"].append(np.asarray(mask, np.int32))
        rows["token_type_ids"].append(np.asarray(types, np.int32))
        rows["masked_positions"].append(pos_arr)
        rows["masked_ids"].append(tgt_arr)
    return {k: np.stack(v) for k, v in rows.items()}
