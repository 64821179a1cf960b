"""Command-line entry point: ``attack cw``, ``knn``, ``geoa3`` and ``geoa3-partial``.

Counterpart of ``pointcloudattack_tpu/cli/main.py::cmd_attack`` for the
``cw``, ``knn``, ``geoa3`` and ``geoa3-partial`` families.  Run as

    python -m pointcloudattack_tpu_torch.cli attack cw --dataset synthetic \\
        --model PointNet --num_points 1024 --num_classes 40 \\
        --checkpoint model.pth --binary_step 1 --num_iter 200 --kappa 30 \\
        --budget 0.18 --num_samples 64 --seed 0 --device cuda \\
        --output_dir runs --save_adv
    python -m pointcloudattack_tpu_torch.cli attack knn --model PointNet \\
        --num_iter 500 --attack_lr 0.01 --nn_refresh 1 --num_samples 64
    python -m pointcloudattack_tpu_torch.cli attack geoa3 --model PointNet \\
        --num_classes 40 --binary_step 10 --num_iter 500 --num_samples 8 \\
        --curv_knn_refresh 4 --use_jitter 1
    python -m pointcloudattack_tpu_torch.cli attack geoa3-partial \\
        --model PointNet --knn_range 16 --refresh_iters 50 \\
        --subsample_npoint 512 --curv_knn_refresh 4

``--model`` is ``PointNet``, ``PointNet++Ssg``, ``PointNet++Msg``,
``DGCNN`` or ``CurveNet`` (whose raw logits the attacks see as
log-probs, as the JAX CLI normalises them).  ``--num_iter 0`` /
``--binary_step 0`` mean the family's reference default (C&W and GeoA3
10 x 500, KNN 2500).  ``geoa3-partial`` takes the settings the JAX CLI
passes it: the step size, the rounds and iterations, the classification
loss and its confidence, ``--curv_knn_refresh``, ``--knn_range``,
``--refresh_iters`` and ``--subsample_npoint``.  ``--device`` defaults to
``cuda`` and never drops to the CPU; pass ``--device cpu`` to run the
plain versions of the kernels.  Without ``--checkpoint`` the victim's
weights are drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds

ATTACK_FAMILIES = ("cw", "knn", "geoa3", "geoa3-partial")


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available on this host "
            "(pass --device cpu to run the plain CPU versions)"
        )
    return dev


def _normalize_output(fn, model_name: str):
    """Raw-logit models (CurveNet) -> log-probs, so that CE-based attack
    losses stay right (margin losses are shift-invariant), as the JAX CLI's
    ``_normalize_output`` does."""
    from pointcloudattack_tpu_torch import models

    if models.OUTPUT_KIND[model_name] != "logits":
        return fn
    return lambda x: torch.log_softmax(fn(x), dim=-1)


def imperceptibility_metrics(adv: torch.Tensor, ori: torch.Tensor) -> dict:
    """MSE, adv->ori Chamfer and Hausdorff (squared distances, mean over
    the batch) and the count of moved points, as the JAX CLI reports."""
    from pointcloudattack_tpu_torch.losses.distance import chamfer_dist, hausdorff_dist

    n = ori.shape[1]
    diff = adv - ori
    mse = float(torch.sqrt((diff**2).mean()))
    with torch.no_grad():
        cd = float(chamfer_dist(adv, ori).mean())
        hd = float(hausdorff_dist(adv, ori).mean())
    return {
        "mse": mse,
        "mse_scaled": mse * float(np.sqrt(3 * n)),
        "chamfer": cd,
        "hausdorff": hd,
        "num_perturbed_points": int((diff.abs().amax(dim=-1) > 1e-6).sum()),
    }


def _dump_adv(outdir, name, adv, labels, preds):
    os.makedirs(outdir, exist_ok=True)
    for i in range(len(adv)):
        path = os.path.join(
            outdir, f"{name}_{i}_label{int(labels[i])}_pred{int(preds[i])}.txt"
        )
        np.savetxt(path, adv[i], fmt="%.6f")


def _run_family(args, model_fn, data, target, noise_gen):
    """One attack family; returns ``(adv, success)``."""
    if args.family == "cw":
        from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

        cfg = CWPerturbConfig(
            attack_lr=args.attack_lr,
            binary_step=args.binary_step or 10,
            num_iter=args.num_iter or 500,
            kappa=args.kappa,
            budget=args.budget,
        )
        res = build_cw_attack(model_fn, cfg)(data, target, generator=noise_gen)
        return res.best_attack, res.success
    if args.family == "geoa3":
        from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

        cfg = GeoA3Config(
            lr=args.attack_lr, binary_max_steps=args.binary_step or 10, iter_max_steps=args.num_iter or 500,
            cls_loss_type=args.cls_loss_type, confidence=args.confidence, dis_loss_type=args.dis_loss_type,
            dis_loss_weight=args.dis_loss_weight, is_cd_single_side=bool(args.is_cd_single_side),
            hd_loss_weight=args.hd_loss_weight, curv_loss_weight=args.curv_loss_weight,
            curv_loss_knn=args.curv_loss_knn, curv_knn_refresh=args.curv_knn_refresh,
            initial_const=args.initial_const, use_lr_scheduler=bool(args.use_lr_scheduler),
            use_jitter=bool(args.use_jitter), use_offset_proj=bool(args.use_offset_proj), cc_linf=args.cc_linf,
        )
        adv, _, success = build_geoa3_attack(model_fn, cfg)(data, target, generator=noise_gen)
        return adv, success
    if args.family == "geoa3-partial":
        from pointcloudattack_tpu_torch.attacks.geoa3_partial import GeoA3PartialConfig, build_geoa3_partial_attack

        cfg = GeoA3PartialConfig(
            lr=args.attack_lr, binary_max_steps=args.binary_step or 10, iter_max_steps=args.num_iter or 500,
            cls_loss_type=args.cls_loss_type, confidence=args.confidence, curv_knn_refresh=args.curv_knn_refresh,
            knn_range=args.knn_range, refresh_iters=args.refresh_iters, subsample_npoint=args.subsample_npoint,
        )
        adv, _, success = build_geoa3_partial_attack(model_fn, cfg)(data, target, generator=noise_gen)
        return adv, success
    from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack

    cfg = KNNAttackConfig(
        attack_lr=args.attack_lr,
        num_iter=args.num_iter or 2500,
        kappa=args.kappa,
        budget=args.budget,
        nn_refresh=args.nn_refresh,
    )
    return build_knn_attack(model_fn, cfg)(data, target, generator=noise_gen)


def cmd_attack(args) -> float:
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.engine import shuffle_check
    from pointcloudattack_tpu_torch.train.weights import load_checkpoint
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    dev = _device(args.device)
    num_classes = args.num_classes or 10
    clouds, labels = make_synthetic_clouds(num_classes, 16, args.num_points, seed=args.seed)
    if args.num_samples:
        clouds, labels = clouds[: args.num_samples], labels[: args.num_samples]
    data = torch.from_numpy(clouds).to(dev)
    target = torch.from_numpy(labels.astype(np.int64)).to(dev)

    gen = torch.Generator().manual_seed(args.seed)
    model = models.make_model(args.model, num_classes, generator=gen)
    state = load_checkpoint(args.checkpoint) if args.checkpoint else None
    if state is None:
        print(
            f"no --checkpoint: {args.model} weights drawn from seed {args.seed}",
            file=sys.stderr,
        )
    model_fn = _normalize_output(make_model_fn(model, state, dev), args.model)

    noise_gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    adv, success = _run_family(args, model_fn, data, target, noise_gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    success = success.cpu().numpy()
    asr = float(success.mean())
    family = args.family
    print(
        f"attack {family}: ASR {asr:.3f} "
        f"({int(success.sum())}/{len(success)}) in {dt:.1f}s"
    )
    summary = {
        "family": family, "model": args.model, "asr": asr,
        "wall_clock_s": dt, "n": int(len(success)), "device": str(dev),
    }
    im = imperceptibility_metrics(adv, data)
    summary.update(im)
    print(
        f"MSE {im['mse']:.6f}  Chamfer {im['chamfer']:.6f}  "
        f"Hausdorff {im['hausdorff']:.6f}"
    )

    if args.save_adv:
        with torch.no_grad():
            preds = model_fn(adv).argmax(dim=-1)
        _dump_adv(
            os.path.join(args.output_dir, "AdvData", args.model), family,
            adv.cpu().numpy(), labels, preds.cpu().numpy(),
        )

    shuf_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shuf = float(shuffle_check(model_fn, adv, target, shuf_gen).float().mean())
    summary["shuffle_asr"] = shuf
    print(f"shuffle-robust ASR: {shuf:.3f}")

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, f"attack_{family}_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return asr


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pointcloudattack_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("attack")
    p.add_argument("family", choices=list(ATTACK_FAMILIES), help="attack family")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    p.add_argument("--model", default="PointNet",
                   choices=["PointNet", "PointNet++Ssg", "PointNet++Msg", "DGCNN", "CurveNet"])
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_classes", type=int, default=0, help="0 = 10")
    p.add_argument("--checkpoint", default="", help="reference-layout .pth state dict")
    p.add_argument("--binary_step", type=int, default=0, help="cw, geoa3, geoa3-partial: 0 = 10")
    p.add_argument("--num_iter", type=int, default=0,
                   help="0 = the family's default (cw and geoa3 500, knn 2500)")
    p.add_argument("--attack_lr", type=float, default=1e-2)
    p.add_argument("--nn_refresh", type=int, default=1,
                   help="knn: refresh the Chamfer nearest-point index every R iterations (1 = the reference)")
    # GeoA3's loss settings, the reference Eval_GeoA3 defaults
    p.add_argument("--cls_loss_type", default="CE", choices=["CE", "Margin", "None"])
    p.add_argument("--confidence", type=float, default=0.0, help="geoa3: margin confidence (Margin loss)")
    p.add_argument("--dis_loss_type", default="CD", choices=["CD", "L2", "None"])
    p.add_argument("--dis_loss_weight", type=float, default=1.0)
    p.add_argument("--is_cd_single_side", type=int, default=0)
    p.add_argument("--hd_loss_weight", type=float, default=0.1)
    p.add_argument("--curv_loss_weight", type=float, default=1.0)
    p.add_argument("--curv_loss_knn", type=int, default=16)
    p.add_argument("--curv_knn_refresh", type=int, default=1,
                   help="geoa3: recompute the curvature's neighbour set every R iterations "
                        "(1 = the reference's per-iteration kNN)")
    p.add_argument("--initial_const", type=float, default=10.0)
    p.add_argument("--use_lr_scheduler", type=int, default=0)
    p.add_argument("--use_jitter", type=int, default=0,
                   help="geoa3: jitter the loss's input in each point's tangent plane")
    p.add_argument("--use_offset_proj", type=int, default=0, help="geoa3: project offsets on the clean normals")
    p.add_argument("--cc_linf", type=float, default=0.0, help="geoa3: per-point offset length cap (0 = off)")
    p.add_argument("--knn_range", type=int, default=16, help="geoa3-partial: points in a patch")
    p.add_argument("--refresh_iters", type=int, default=50,
                   help="geoa3-partial: iterations between patch refreshes")
    p.add_argument("--subsample_npoint", type=int, default=0,
                   help="geoa3-partial: evaluate on a farthest-point subsample of this size (0 = off)")
    p.add_argument("--kappa", type=float, default=30.0)
    p.add_argument("--budget", type=float, default=0.18)
    p.add_argument("--num_samples", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--save_adv", action="store_true")
    p.set_defaults(fn=cmd_attack)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
