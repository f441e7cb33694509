"""The BERT compression subsystem on PyTorch (counterpart of the JAX
package's `nlp/`, the reference's `xcompression/`):

* automatic tensorization: `split_to_factors`, and TT / SVD ranks from a
  target ratio (`compute_ranks_tt`, `compute_rank_svd`);
* factorized embeddings: SVD, TT (mixed-radix index lookup), word2ket
  Kronecker (`KetEmbedding`, `KetXSEmbedding`) and TTM;
* BERT, dense and compressed by a `BertCompressionPlan`;
* two-stage task distillation (attention + hidden MSE, then soft logits),
  general distillation over masked-LM examples, SQuAD with EM/F1, and the
  cross-layer shared Tucker encoder;
* `python -m dnn_compression_tensor_admm_tpu_torch.nlp {task-distill,
  general-distill,squad}`.
"""

from .bert import (BertCompressionPlan, BertConfig, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .distill import attention_hidden_distill_loss, soft_logits_loss
from .factorization import (compute_rank_svd, compute_ranks_tt, get_factors,
                            split_to_factors, svd_spec_from_ratio,
                            tt_linear_spec_from_ratio)
from .ket_embedding import (EarlyStopping, KetEmbedding, KetXSEmbedding,
                            fit_ket_to_dense, ket_rank_from_ratio)
from .optimization import BertAdam
from .svd_embedding import SVDEmbedding
from .tt_embedding import TTEmbedding
from .ttm_layers import TTMEmbedding, TTMLinear
