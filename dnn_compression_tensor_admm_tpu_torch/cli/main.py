"""Command line: the JAX package's `cli/main.py` surface for the port's
model zoo (ResNet-20/32/56, MobileNetV2-CIFAR and DenseNet-40/100 on
CIFAR-10/100 files or synthetic CIFAR geometry; DeiT-tiny, DeiT-small,
ViT-small, ImageNet ResNet-18/34/50, MobileNetV2, VGG16(-BN) and
DenseNet-121/201/264 on synthetic ImageNet geometry), each dense or under
the prefix of its format: `tt{m,r,c}_`, `tk{m,r,c}_`, `svd{m,r,c}_` and
the Stiefel Tucker-2 `stftkc_` (its factors kept orthonormal by
Riemannian SGD). `--ratio` picks a reference table where one exists;
any other number above 1 takes the automatic rank plan.

Pipeline modes:
  (default)     train (dense baseline, or ADMM with --admm)
  --decompose   factorize a dense checkpoint (--model-path) and fine-tune
  --pretrained  load an already-factorized checkpoint (--model-path)
  --eval        evaluate a checkpoint (or the freshly decomposed model)
  --runtime     latency benchmark
  --export PATH, --export-onnx PATH
                write the loaded model as a torch.export program or an
                ONNX file, then stop unless --eval or --runtime is given

Run as `python -m dnn_compression_tensor_admm_tpu_torch ...`; it runs on
the card unless given `--device cpu`. `--model-path` and `--teacher-path`
read the JAX package's `.msgpack` checkpoints, the port's torch state
dicts (`.pt`) and the reference's `.pth` files (the JAX package's
`variables_to_torch` naming, torchvision's; wrapped in `state_dict` or
`model` or not); `--save-model` writes `{tag}_{ts}_model.msgpack` as the JAX
package does, so its two-stage recipes chain (`--admm --save-model`, then
`--decompose --model-path` of that file). `--checkpoint-dir` writes the
whole train state after each epoch and `--resume` goes on from it.

The ViT recipe's augmentations (`--mixup --cutmix --aa rand-m9-mstd0.5
--reprob --repeated-aug`) and `--sampling` are the JAX CLI's. `--shard-dir`
streams `train-*.dcta` shards (made with `data/records.py::write_shards`)
through the native loader, which the port builds from
`native/dataloader.cc` at first use, and evaluates on `val-*.dcta`;
`--shard-cache hbm` reads them whole onto the device-resident route.
`--flops` prints the model's FLOPs and parameters (and the dense model's
beside a compressed one) and exits; `--profile-dir D` writes a
`torch.profiler` Chrome trace of the first epoch's X-step to
`D/trace.json` (the later epochs of that process run slower: trace a
short run).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Tensor-decomposition ADMM compression (PyTorch/CUDA)")
    p.add_argument("--model", default="resnet32", type=str,
                   help="a dense name (resnet20|32|56, mobilenetv2_cifar, "
                        "densenet40|100, deit_tiny_patch16_224, "
                        "deit_small_patch16_224, vit_small_patch16_224, "
                        "resnet18|34|50, mobilenetv2, vgg16, vgg16_bn, "
                        "densenet121|201|264) or one with a format prefix: "
                        "ttm_|ttr_|ttc_, tkm_|tkc_|tkr_, svdm_|svdc_|svdr_, "
                        "stftkc_ (e.g. tkc_resnet32, svdc_mobilenetv2, "
                        "stftkc_resnet32)")
    p.add_argument("--dataset", default="synthetic-cifar10", type=str,
                   help="cifar10 | cifar100 | mnist (files in --data-dir) | "
                        "synthetic-cifar10 | synthetic-hard-cifar10 | "
                        "synthetic-imagenet | synthetic-hard-imagenet")
    p.add_argument("--data-dir", default=None, type=str,
                   help="the dataset's files (cifar-10-batches-py or "
                        "cifar-10-python.tar.gz, cifar-100-python, MNIST "
                        "idx); nothing is downloaded")
    p.add_argument("--num-classes", default=None, type=int,
                   help="the head's classes (default: the dataset's)")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--steps-per-epoch", default=None, type=int)
    p.add_argument("--synthetic-size", default=None, type=int)
    p.add_argument("--opt", default="momentum",
                   choices=["momentum", "adamw", "sgd", "adam"],
                   help="sgd is Nesterov momentum; adam has no weight decay")
    p.add_argument("--lr", default=0.1, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", default=1e-4, type=float)
    p.add_argument("--sched", default="cosine",
                   choices=["cosine", "step", "constant"])
    p.add_argument("--warmup-epochs", default=0, type=int,
                   help="linear warmup from 1e-6 to --lr before the cosine")
    p.add_argument("--min-lr", default=1e-5, type=float)
    p.add_argument("--decay-epochs", default=30, type=int,
                   help="step: the lr x --decay-rate every N epochs")
    p.add_argument("--decay-rate", default=0.1, type=float)
    p.add_argument("--clip-grad", default=None, type=float,
                   help="clip the gradients by this global norm")
    p.add_argument("--smoothing", default=0.0, type=float)
    p.add_argument("--mixup", default=0.0, type=float,
                   help="Mixup alpha (0 = off)")
    p.add_argument("--cutmix", default=0.0, type=float,
                   help="CutMix alpha (0 = off)")
    p.add_argument("--aa", default=None, type=str, metavar="rand-mN-mstdS",
                   help="RandAugment policy string (timm syntax, e.g. "
                        "rand-m9-mstd0.5)")
    p.add_argument("--reprob", default=0.0, type=float,
                   help="RandomErasing probability")
    p.add_argument("--repeated-aug", default=0, type=int,
                   help="repeated-augmentation views per image (RASampler)")
    p.add_argument("--sampling", default="perm",
                   choices=["perm", "shuffle", "replacement"],
                   help="'perm' gathers a slice of the epoch's permutation "
                        "a step, 'shuffle' slices a shuffled copy (the same "
                        "rows), 'replacement' samples uniformly a step")
    p.add_argument("--admm", action="store_true")
    p.add_argument("--rho", default=0.001, type=float)
    p.add_argument("--format", dest="fmt", default="tk",
                   choices=["tk", "tt", "svd"],
                   help="rank format of the ADMM plan")
    p.add_argument("--ratio", default="2", type=str,
                   help="the rank table's ratio (e.g. 2, 3, sc); another "
                        "number above 1 takes the automatic rank plan")
    p.add_argument("--tt-type", default="general",
                   choices=["general", "special"])
    p.add_argument("--admm-method", default="kernel",
                   choices=["kernel", "subspace", "gram", "svd", "ns"],
                   help="Z-step solver: 'kernel' is the CUDA Tucker-2 factor "
                        "kernel for tk and svd and the CUDA subspace kernel's "
                        "TT-SVD sweep for tt (plain torch on the CPU); "
                        "'gram' eigh of the Gram, 'ns' orthogonal iteration "
                        "with Newton-Schulz")
    p.add_argument("--adjust-rho", action="store_true",
                   help="5x rho boost after 85%% of epochs (reference "
                        "admm.py:87-89; off by default)")
    p.add_argument("--orthogonal", action="store_true",
                   help="add the factors' soft-orthogonality penalty at rho")
    p.add_argument("--decompose", action="store_true")
    p.add_argument("--pretrained", action="store_true",
                   help="load an already-factorized checkpoint "
                        "(--model-path) and fine-tune it")
    p.add_argument("--model-path", default=None, type=str,
                   help="a .msgpack (the JAX package's layout) or .pt")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--runtime", action="store_true")
    p.add_argument("--distillation-type", default="none",
                   choices=["none", "soft", "hard"])
    p.add_argument("--distillation-alpha", default=0.5, type=float)
    p.add_argument("--distillation-tau", default=1.0, type=float)
    p.add_argument("--teacher-model", default=None, type=str)
    p.add_argument("--teacher-path", default=None, type=str,
                   help="the teacher's weights, a .msgpack or .pt")
    p.add_argument("--ema-decay", default=0.0, type=float,
                   help="> 0: keep an EMA of the parameters and evaluate it "
                        "too (ema_test_* in each eval row)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--output-dir", default="saved_models", type=str)
    p.add_argument("--save-model", action="store_true")
    p.add_argument("--save-log", action="store_true")
    p.add_argument("--eval-every", default=1, type=int)
    p.add_argument("--resume", default=None, type=str,
                   help="a --checkpoint-dir to resume the whole train "
                        "state (ADMM duals included) from")
    p.add_argument("--checkpoint-dir", default=None, type=str,
                   help="write the whole train state after each epoch")
    p.add_argument("--verbose", action="store_true",
                   help="per-layer ADMM residual rows (reference --verbose)")
    p.add_argument("--profile-dir", default=None, type=str,
                   help="write a torch.profiler trace of the first epoch's "
                        "X-step to DIR/trace.json (later epochs of the "
                        "process run slower after it: trace a short run)")
    p.add_argument("--shard-dir", default=None, type=str,
                   help="directory of DCTA record shards (train-*.dcta / "
                        "val-*.dcta) streamed by the native loader")
    p.add_argument("--loader-workers", default=4, type=int,
                   help="the native shard loader's threads")
    p.add_argument("--shard-cache", default=None, choices=["hbm"],
                   help="with --shard-dir: read the shards whole onto the "
                        "device-resident route instead of streaming them")
    p.add_argument("--export", default=None, type=str, metavar="PATH",
                   help="after loading, write the eval-mode model at "
                        "--batch-size as a torch.export program (NCHW "
                        "input; the JAX package writes StableHLO)")
    p.add_argument("--export-savedmodel", default=None, type=str,
                   metavar="DIR",
                   help="a TF SavedModel needs tensorflow and jax2tf: "
                        "refused here, use --export-onnx")
    p.add_argument("--export-onnx", default=None, type=str, metavar="PATH",
                   help="write a .onnx file at batch 1 (ResNet families "
                        "and ViT/DeiT, dense or factorized; no onnx "
                        "package needed)")
    p.add_argument("--flops", action="store_true",
                   help="print the model's FLOPs and parameters and exit")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def export_all(args, model, info, num_classes: int) -> dict:
    """The exports asked for (`--export-onnx`, `--export`,
    `--export-savedmodel`, in the JAX CLI's order) -> the seconds of each
    (`export_onnx_s`, `export_s`)."""
    from ..models.vit import _VIT_CFGS
    from ..utils.export import export_model, export_savedmodel
    from ..utils.onnx_export import export_onnx

    size = info.input_size
    shape = (args.batch_size, len(info.mean), size, size)
    done = {}
    if args.export_onnx:
        t0 = time.perf_counter()
        heads = next((h for k, (_, _, h) in _VIT_CFGS.items()
                      if args.model.endswith(k)), None)
        export_onnx(model, args.export_onnx, num_classes=num_classes,
                    input_size=size, num_heads=heads)
        done["export_onnx_s"] = time.perf_counter() - t0
        print(f"exported ONNX model to {args.export_onnx}")
    if args.export:
        t0 = time.perf_counter()
        export_model(model, shape, args.export)
        done["export_s"] = time.perf_counter() - t0
        print(f"exported torch.export program to {args.export}")
    if args.export_savedmodel:
        export_savedmodel(model, shape, args.export_savedmodel)
    return done


def main(argv=None):
    args = parse_args(argv)


    from ..configs.resolver import get_rank_plan
    from ..data.augment import parse_randaugment
    from ..data.datasets import dataset_info, load_dataset
    from ..models import (compression_ratio, create_model, decompose_params,
                          parse_compressed_name)
    from ..train import TrainConfig, eval_runtime, evaluate_model, train_model
    from ..utils.checkpoint import load_any_variables, save_variables
    from ..utils.device import resolve_device
    from ..utils.jax_weights import state_dict_to_jax

    device = resolve_device(args.device)
    compressed = parse_compressed_name(args.model)
    if args.admm and compressed is not None:
        raise SystemExit("ERROR: --admm requires an uncompressed model name")
    info = dataset_info(args.dataset)
    num_classes = args.num_classes or info.num_classes
    compute_dtype = None if args.fp32 else "bfloat16"
    kw = {"ratio": args.ratio, "tt_type": args.tt_type} if compressed else {}

    if args.flops:
        from ..utils.flops import model_flops_params
        shape = (1, len(info.mean), info.input_size, info.input_size)
        model = create_model(args.model, num_classes=num_classes, **kw)
        rep = model_flops_params(model.to(device), shape)
        if compressed is not None:
            dense = create_model(compressed[0], num_classes=num_classes)
            drep = model_flops_params(dense.to(device), shape)
            rep["dense_params"] = drep["params"]
            rep["dense_flops"] = drep["flops"]
            rep["param_ratio"] = drep["params"] / rep["params"]
            rep["flop_ratio"] = drep["flops"] / rep["flops"]
        print(json.dumps(rep))
        return rep

    def template(name, **model_kw):
        """The state dict a checkpoint of `name` must map onto."""
        return lambda: create_model(name, num_classes=num_classes,
                                    **model_kw).state_dict()

    exports = args.export or args.export_onnx or args.export_savedmodel
    init_state = None
    if args.decompose:
        if compressed is None:
            raise SystemExit("ERROR: --decompose needs a compressed model name")
        if not args.model_path:
            raise SystemExit("ERROR: --decompose needs --model-path (dense ckpt)")
        base, fmt, _ = compressed
        dense = create_model(base, num_classes=num_classes)
        dense.load_state_dict(load_any_variables(args.model_path,
                                                 dense.state_dict))
        plan = get_rank_plan(args.model, fmt, args.ratio, args.tt_type)
        init_state = decompose_params(dense.to(device).state_dict(), plan)
        model = create_model(args.model, num_classes=num_classes, **kw)
        model.load_state_dict(init_state)
        print(f"decomposed {args.model_path}: compression "
              f"{compression_ratio(dense, model):.2f}x")
    elif args.pretrained:
        if not args.model_path:
            raise SystemExit("ERROR: --pretrained needs --model-path")
        if not (args.eval or args.runtime or exports):  # else read below
            init_state = load_any_variables(args.model_path,
                                            template(args.model, **kw))

    if args.eval or args.runtime or exports:
        model = create_model(args.model, num_classes=num_classes, **kw)
        if init_state is None:
            if not args.model_path:
                raise SystemExit("ERROR: --eval/--runtime/--export need "
                                 "--model-path")
            init_state = load_any_variables(args.model_path, model.state_dict)
        model.load_state_dict(init_state)
        model.to(device)
        if exports:
            r = export_all(args, model, info, num_classes)
            if not (args.eval or args.runtime):
                return r
        if args.runtime:
            r = eval_runtime(model, info, batch_size=args.batch_size,
                             compute_dtype=compute_dtype)
        else:
            x, y, _ = load_dataset(args.dataset, False, args.synthetic_size,
                                   args.data_dir)
            r = evaluate_model(model, x, y, info, compute_dtype=compute_dtype)
        print(json.dumps(r))
        return r

    randaug = parse_randaugment(args.aa)
    cfg = TrainConfig(
        model=args.model, dataset=args.dataset, batch_size=args.batch_size,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        num_classes=args.num_classes, data_dir=args.data_dir,
        opt=args.opt, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        sched=args.sched, min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs, decay_epochs=args.decay_epochs,
        decay_rate=args.decay_rate,
        clip_grad=args.clip_grad, smoothing=args.smoothing,
        mixup=args.mixup, cutmix=args.cutmix,
        randaug_magnitude=randaug[0], randaug_std=randaug[1],
        erase_prob=args.reprob, repeated_aug=args.repeated_aug,
        sampling=args.sampling, shard_dir=args.shard_dir,
        shard_cache=args.shard_cache, loader_workers=args.loader_workers,
        profile_dir=args.profile_dir, admm=args.admm,
        rho=args.rho, fmt=args.fmt, ratio=args.ratio, tt_type=args.tt_type,
        admm_method=args.admm_method, adjust_rho_late=args.adjust_rho,
        verbose_admm=args.verbose, orthogonal=args.orthogonal,
        distillation_type=args.distillation_type,
        distillation_alpha=args.distillation_alpha,
        distillation_tau=args.distillation_tau,
        teacher_model=args.teacher_model,
        teacher_state_dict=(load_any_variables(args.teacher_path,
                                               template(args.teacher_model))
                            if args.distillation_type != "none"
                            and args.teacher_path else None),
        ema_decay=args.ema_decay, eval_every=args.eval_every,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        seed=args.seed,
        compute_dtype=compute_dtype,
        synthetic_size=args.synthetic_size, device=str(device))
    ts = time.strftime("%m%d-%H%M%S")
    tag = f"{args.model}_{args.dataset}"
    if args.admm:
        tag += f"_admm_{args.fmt}"
    if args.save_log:
        os.makedirs(args.output_dir, exist_ok=True)
        cfg.log_path = os.path.join(args.output_dir, f"{tag}_{ts}.log")
    model, history = train_model(cfg, init_state_dict=init_state)
    if args.save_model:
        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir, f"{tag}_{ts}_model.msgpack")
        save_variables(path, state_dict_to_jax(model.state_dict()))
        print(f"saved model to {path}")
    return model, history


if __name__ == "__main__":
    main()
