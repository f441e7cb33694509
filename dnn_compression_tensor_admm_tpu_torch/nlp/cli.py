"""The NLP command line (counterpart of the JAX package's `nlp/cli.py`;
the reference's task_distill.py, general_distill.py, run_squad.py):

    python -m dnn_compression_tensor_admm_tpu_torch.nlp task-distill \\
        --task sst-2 --data-dir glue/SST-2 --linear-format tt --ratio 2 \\
        --stage1-epochs 3 --stage2-epochs 3
    python -m dnn_compression_tensor_admm_tpu_torch.nlp general-distill --epochs 2
    python -m dnn_compression_tensor_admm_tpu_torch.nlp squad \\
        --train-json train-v1.1.json --dev-json dev-v1.1.json --output-dir out

The JAX CLI's flags and defaults (BERT-base, sequence 128, batch 32, TT
linears at ratio 2 and an SVD word embedding at 4.5x), plus `--device`
(default cuda; `--device cpu` runs on the CPU, nothing falls back) and
task-distill's `--save-teacher`. Without `--data-dir` / `--*-json` the
synthetic corpora run. `--save` and `--save-teacher` write the flax
msgpack that the JAX package's `utils.load_variables` reads;
`--teacher-path` reads one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def _add_bert_flags(p):
    p.add_argument("--hidden-size", type=int, default=None,
                   help="override BERT hidden size (default: base, 768)")
    p.add_argument("--num-layers", type=int, default=None)
    p.add_argument("--num-heads", type=int, default=None)
    p.add_argument("--intermediate-size", type=int, default=None)
    p.add_argument("--max-seq-length", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab-path", type=str, default=None)
    p.add_argument("--dropout", type=float, default=None,
                   help="override hidden+attention dropout (small synthetic "
                        "configs learn poorly at the BERT default 0.1)")
    p.add_argument("--linear-format", default="tt",
                   choices=["tt", "svd", "none"])
    p.add_argument("--ratio", dest="linear_ratio", type=float, default=2.0)
    p.add_argument("--tt-dim", type=int, default=2)
    p.add_argument("--embedding-format", default="svd",
                   choices=["svd", "tt", "ket", "ketxs", "none"])
    p.add_argument("--embedding-ratio", type=float, default=4.5)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda raises where absent")


def _bert_config(args):
    from .bert import BertConfig
    cfg = BertConfig()
    over = {k: getattr(args, k) for k in
            ("hidden_size", "num_layers", "num_heads", "intermediate_size")
            if getattr(args, k) is not None}
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if args.dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=args.dropout,
                                  attn_dropout=args.dropout)
    return dataclasses.replace(cfg, max_position=max(args.max_seq_length,
                                                     cfg.max_position))


def _plan(args):
    from .bert import BertCompressionPlan
    return BertCompressionPlan(
        linear_format=None if args.linear_format == "none" else args.linear_format,
        linear_ratio=args.linear_ratio, tt_dim=args.tt_dim,
        embedding_format=(None if args.embedding_format == "none"
                          else args.embedding_format),
        embedding_ratio=args.embedding_ratio)


def _save(path: str, model) -> None:
    from ..utils.checkpoint import save_variables
    from ..utils.jax_weights import state_dict_to_jax
    save_variables(path, state_dict_to_jax(model.state_dict()))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dnn_compression_tensor_admm_tpu_torch.nlp",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    td = sub.add_parser("task-distill",
                        help="two-stage GLUE task distillation")
    _add_bert_flags(td)
    td.add_argument("--task", default="sst-2")
    td.add_argument("--data-dir", default=None,
                    help="GLUE task directory (TSV files); default synthetic")
    td.add_argument("--n-synthetic", type=int, default=512,
                    help="synthetic-corpus size (offline mode)")
    td.add_argument("--stage1-epochs", type=int, default=1)
    td.add_argument("--stage2-epochs", type=int, default=1)
    td.add_argument("--lr-stage1", type=float, default=5e-5)
    td.add_argument("--lr-stage2", type=float, default=3e-5)
    td.add_argument("--grad-accum-steps", type=int, default=1)
    td.add_argument("--teacher-epochs", type=int, default=4,
                    help="synthetic-mode teacher fine-tune budget")
    td.add_argument("--teacher-lr", type=float, default=1e-3)
    td.add_argument("--teacher-path", default=None,
                    help="msgpack of fine-tuned dense teacher variables")
    td.add_argument("--save", default=None, help="save student variables to")
    td.add_argument("--save-teacher", default=None,
                    help="save the (fine-tuned) teacher's variables to")

    gd = sub.add_parser("general-distill",
                        help="pretraining-corpus distillation")
    _add_bert_flags(gd)
    gd.add_argument("--corpus", default=None,
                    help="text file, one document per line; default synthetic")
    gd.add_argument("--epochs", type=int, default=1)
    gd.add_argument("--lr", type=float, default=1e-4)
    gd.add_argument("--save", default=None)

    sq = sub.add_parser("squad", help="extractive QA fine-tune + EM/F1")
    _add_bert_flags(sq)
    sq.add_argument("--train-json", default=None)
    sq.add_argument("--dev-json", default=None)
    sq.add_argument("--epochs", type=int, default=2)
    sq.add_argument("--lr", type=float, default=5e-4)
    sq.add_argument("--doc-stride", type=int, default=64)
    sq.add_argument("--n-best-size", type=int, default=20)
    sq.add_argument("--max-answer-length", type=int, default=30)
    sq.add_argument("--output-dir", default=None,
                    help="write predictions.json / nbest_predictions.json")
    sq.add_argument("--save", default=None)
    return ap


def main(argv=None):
    """-> (model, history); the last history row is printed as
    {"final": ...}."""
    args = parser().parse_args(argv)

    if args.cmd == "task-distill":
        from .task_distill import DistillConfig, run_task_distillation
        teacher_state = None
        if args.teacher_path:
            from ..utils.checkpoint import load_variables
            from ..utils.jax_weights import jax_to_state_dict
            teacher_state = jax_to_state_dict(load_variables(args.teacher_path))
        cfg = DistillConfig(
            task=args.task, data_dir=args.data_dir,
            n_synthetic=args.n_synthetic,
            vocab_path=args.vocab_path,
            max_seq_length=args.max_seq_length, batch_size=args.batch_size,
            stage1_epochs=args.stage1_epochs, stage2_epochs=args.stage2_epochs,
            lr_stage1=args.lr_stage1, lr_stage2=args.lr_stage2,
            grad_accum_steps=args.grad_accum_steps, seed=args.seed,
            teacher_epochs=args.teacher_epochs, teacher_lr=args.teacher_lr,
            bert=_bert_config(args), plan=_plan(args), device=args.device)
        model, history, teacher = run_task_distillation(cfg, teacher_state)
        if args.save_teacher:
            _save(args.save_teacher, teacher)
            print(f"saved teacher variables to {args.save_teacher}")
    elif args.cmd == "general-distill":
        from .general_distill import (GeneralDistillConfig,
                                      run_general_distillation)
        texts = None
        if args.corpus:
            with open(args.corpus, encoding="utf-8") as f:
                texts = [line.strip() for line in f if line.strip()]
        cfg = GeneralDistillConfig(
            max_seq_length=args.max_seq_length, batch_size=args.batch_size,
            epochs=args.epochs, lr=args.lr, seed=args.seed,
            bert=_bert_config(args), plan=_plan(args), device=args.device)
        model, history = run_general_distillation(cfg, texts=texts)
    else:  # squad
        from .squad import SquadConfig, run_squad
        cfg = SquadConfig(
            max_seq_length=args.max_seq_length, doc_stride=args.doc_stride,
            n_best_size=args.n_best_size,
            max_answer_length=args.max_answer_length,
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            seed=args.seed, output_dir=args.output_dir,
            bert=_bert_config(args), plan=_plan(args), device=args.device)
        model, history = run_squad(cfg, args.train_json, args.dev_json)

    if args.save:
        _save(args.save, model)
        print(f"saved student variables to {args.save}")
    print(json.dumps({"final": history[-1]}))
    return model, history


if __name__ == "__main__":
    main()
