"""Command-line entry point: ``attack cw``, ``knn``, ``geoa3``,
``geoa3-partial``, ``aof``, ``taof``, ``siadv``, ``simba``, ``simbapp`` and
``si-query``.

Counterpart of ``pointcloudattack_tpu/cli/main.py::cmd_attack`` for those
families.  Run as

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
    python -m pointcloudattack_tpu_torch.cli attack aof --model PointNet \
        --binary_step 2 --num_iter 100 --kappa 0 --budget 0.45 --low_pass 100
    python -m pointcloudattack_tpu_torch.cli attack taof --attack_method target
    python -m pointcloudattack_tpu_torch.cli attack siadv --budget 0.18 \
        --step_size 0.007 --num_iter 50
    python -m pointcloudattack_tpu_torch.cli attack si-query --budget 0.18 \
        --step_size 0.32 --surrogate_model PointNet --surrogate_checkpoint s.pth

``--model`` is ``PointNet``, ``PointNet++Ssg``, ``PointNet++Msg``,
``DGCNN`` or ``CurveNet`` (whose raw logits the attacks see as
log-probs, as the JAX CLI normalises them).  ``--num_iter 0`` /
``--binary_step 0`` mean the family's reference default (C&W and GeoA3
10 x 500, KNN 2500, AOF and TAOF 2 x 200, siadv 50 steps; for simba and
simbapp ``--num_iter`` caps the loop's iterations, by default 3 x 1024, and
si-query runs up to N, as the JAX package's; the query families print the
mean query cost).  ``--attack_method target`` (aof,
taof and the SIadv families) attacks ``--target_class``, by default the
class after the truth; TAOF's success rule reads the true labels.  siadv,
simbapp and si-query take their gradients from ``--surrogate_model`` with
``--surrogate_checkpoint`` when given, else from the victim.  aof and taof
also write ``{family}_results.npz`` (the adversarial clouds, the true
labels and the targets).  ``geoa3-partial`` takes the settings the JAX CLI
passes it: the step size, the rounds and iterations, the classification
loss and its confidence, ``--curv_knn_refresh``, ``--knn_range``,
``--refresh_iters`` and ``--subsample_npoint``.  ``--device`` defaults to
``cuda`` and never drops to the CPU; pass ``--device cpu`` to run the
plain versions of the kernels.  Without ``--checkpoint`` the victim's
weights are drawn from ``--seed``.

``--defense sor|srs|dupnet`` puts a pre-processing defense in front of the
victim for every family (``attacks/evaluation.py::with_defense``; SRS's draw
seeded with ``--seed`` + 7, the same on every forward): the attack, its
white-box gradients (without a surrogate), the shuffle check and
``--save_adv``'s predictions all see the defended victim.  ``dupnet`` needs
``--defense_checkpoint``, a reference-layout PU-Net state dict (the
reference's ``pu-in_1024-up_4.pth``): a randomly initialised upsampler does
not defend.  ``--transfer_test`` scores the adversarial clouds against the
undefended panel ``--trans_model`` (comma-separated, paired positionally with
``--trans_checkpoint``; a repeated name gets a ``#i`` suffix; a member with
no checkpoint runs on weights drawn from ``--seed``, with a warning) and
writes ``transfer_asr`` into the summary:

    python -m pointcloudattack_tpu_torch.cli attack si-query --defense dupnet \
        --defense_checkpoint pu-in_1024-up_4.pth --budget 0.18 --step_size 0.32
    python -m pointcloudattack_tpu_torch.cli attack cw --defense sor \
        --transfer_test --trans_model PointNet,DGCNN --trans_checkpoint a.pth,b.pth
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

ATTACK_FAMILIES = ("cw", "knn", "geoa3", "geoa3-partial", "aof", "taof", "siadv", "simba", "simbapp", "si-query")
# the families that take --attack_method target
TARGETED_FAMILIES = ("aof", "taof", "siadv", "simba", "simbapp", "si-query")


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


def _surrogate_model_fn(args, num_classes, dev):
    """The SIadv families' white-box surrogate (reference Eval_SIadv.py:180-182,
    a surrogate PointNet against the target model), or None: the victim."""
    if not args.surrogate_model:
        return None
    if not args.surrogate_checkpoint:
        raise SystemExit("--surrogate_model requires --surrogate_checkpoint "
                         "(a randomly initialized surrogate gives useless gradients)")
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.train.weights import load_checkpoint
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    model = models.make_model(args.surrogate_model, num_classes)
    fn = make_model_fn(model, load_checkpoint(args.surrogate_checkpoint), dev)
    return _normalize_output(fn, args.surrogate_model)


def _load_dup_variables(path: str):
    """The trained PU-Net upsampler's state dict for ``--defense dupnet``
    (the reference hard-loads its ``pu-in_1024-up_4.pth``,
    DUP_Net.py:24); without one the CLI refuses to run."""
    if not path:
        raise SystemExit(
            "--defense dupnet requires --defense_checkpoint: a randomly "
            "initialized PU-Net upsampler does not defend (the reference "
            "DUP_Net.py:24 hard-loads its trained pu-in_1024-up_4.pth)"
        )
    from pointcloudattack_tpu_torch.train.weights import load_checkpoint

    return load_checkpoint(path)


def _transfer_panel(args, num_classes, dev):
    """``{name: model_fn}`` of ``--trans_model`` paired positionally with
    ``--trans_checkpoint``, as the JAX CLI builds it: empty names dropped
    after the pairing, a repeated name suffixed ``#2``, ``#3``, ..."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.train.weights import load_checkpoint
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    names = args.trans_model.split(",")
    ckpts = (args.trans_checkpoint or "").split(",")
    if len(ckpts) > len(names) and any(c for c in ckpts[len(names):]):
        raise SystemExit(
            f"--trans_checkpoint lists {len(ckpts)} entries for "
            f"{len(names)} --trans_model entries; pairing is "
            "positional, the extras would be silently dropped"
        )
    ckpts += [""] * (len(names) - len(ckpts))
    panel = {}
    for name, ckpt in zip(names, ckpts):
        if not name:
            continue
        if name not in models.MODEL_REGISTRY:
            raise SystemExit(f"--trans_model {name!r}: choose from {sorted(models.MODEL_REGISTRY)}")
        if not ckpt:
            # a random-init panel member scores meaningless transfer ASR: loud, not silent
            print(
                f"WARNING: transfer panel member {name!r} has "
                "no --trans_checkpoint slot; scoring against "
                "RANDOMLY INITIALIZED weights",
                file=sys.stderr,
            )
        model = models.make_model(name, num_classes, generator=torch.Generator().manual_seed(args.seed))
        fn = _normalize_output(make_model_fn(model, load_checkpoint(ckpt) if ckpt else None, dev), name)
        key, i = name, 2
        while key in panel:
            key, i = f"{name}#{i}", i + 1
        panel[key] = fn
    return panel


def _run_siadv(args, model_fn, data, target, noise_gen, wb_fn):
    """An SIadv family; returns ``(adv, success, queries or None)``."""
    from pointcloudattack_tpu_torch.attacks import siadv

    if args.family == "siadv":
        cfg = siadv.SIAdvConfig(eps=args.budget, step_size=args.step_size, max_steps=args.num_iter or 50,
                                top5_attack=args.top5_attack)
        adv, _, success = siadv.build_si_ifgm(wb_fn, model_fn, cfg)(data, target)
        return adv, success, None
    kw = {"max_queries": args.num_iter} if args.num_iter else {}
    cfg = siadv.SIAdvConfig(eps=args.budget, step_size=args.step_size, top5_attack=args.top5_attack, **kw)
    if args.family == "simba":
        res = siadv.build_simba(model_fn, cfg)(data, target, generator=noise_gen)
    elif args.family == "simbapp":
        res = siadv.build_simbapp(wb_fn, model_fn, cfg)(data, target, generator=noise_gen)
    else:
        res = siadv.build_si_query_attack(wb_fn, model_fn, cfg)(data, target)
    return res.adv, res.success, res.queries


def _run_family(args, model_fn, data, target, noise_gen, truth, wb_fn):
    """One attack family; returns ``(adv, success, queries or None)``.
    ``truth``: the true labels (TAOF's success rule reads them); ``wb_fn``:
    the SIadv families' gradient source."""
    if args.family in ("siadv", "simba", "simbapp", "si-query"):
        return _run_siadv(args, model_fn, data, target, noise_gen, wb_fn)
    if args.family in ("aof", "taof"):
        from pointcloudattack_tpu_torch.attacks.aof import AOFConfig, build_aof_attack

        cfg = AOFConfig(
            attack_lr=args.attack_lr, binary_step=args.binary_step or 2, num_iter=args.num_iter or 200,
            budget=args.budget, kappa=args.kappa, targeted=args.family == "taof", low_pass=args.low_pass,
            gamma=args.aof_gamma,
        )
        adv, _, success = build_aof_attack(model_fn, cfg)(
            data, target, truth if args.family == "taof" else None, generator=noise_gen)
        return adv, success, None
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
        return res.best_attack, res.success, None
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
        return adv, success, None
    if args.family == "geoa3-partial":
        from pointcloudattack_tpu_torch.attacks.geoa3_partial import GeoA3PartialConfig, build_geoa3_partial_attack

        cfg = GeoA3PartialConfig(
            lr=args.attack_lr, binary_max_steps=args.binary_step or 10, iter_max_steps=args.num_iter or 500,
            cls_loss_type=args.cls_loss_type, confidence=args.confidence, curv_knn_refresh=args.curv_knn_refresh,
            knn_range=args.knn_range, refresh_iters=args.refresh_iters, subsample_npoint=args.subsample_npoint,
        )
        adv, _, success = build_geoa3_partial_attack(model_fn, cfg)(data, target, generator=noise_gen)
        return adv, success, None
    from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack

    cfg = KNNAttackConfig(
        attack_lr=args.attack_lr,
        num_iter=args.num_iter or 2500,
        kappa=args.kappa,
        budget=args.budget,
        nn_refresh=args.nn_refresh,
    )
    return (*build_knn_attack(model_fn, cfg)(data, target, generator=noise_gen), None)


def cmd_attack(args) -> float:
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.evaluation import shuffle_robustness, transfer_matrix
    from pointcloudattack_tpu_torch.train.weights import load_checkpoint
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    dev = _device(args.device)
    family = args.family
    dup_variables = _load_dup_variables(args.defense_checkpoint) if args.defense == "dupnet" else None
    targeted = args.attack_method == "target"
    if targeted and family not in TARGETED_FAMILIES:
        raise SystemExit(f"--attack_method target is not ported for {family} (only for {', '.join(TARGETED_FAMILIES)})")
    if family == "simba" and args.surrogate_model:
        raise SystemExit("simba is pure black-box — it takes no surrogate "
                         "(use simbapp or si-query for surrogate gradients)")
    num_classes = args.num_classes or 10
    clouds, labels = make_synthetic_clouds(num_classes, 16, args.num_points, seed=args.seed)
    if args.num_samples:
        clouds, labels = clouds[: args.num_samples], labels[: args.num_samples]
    truth = labels.astype(np.int64)
    if targeted:
        # a target other than the truth: --target_class, else the next class
        labels = np.full_like(truth, args.target_class) if args.target_class >= 0 else (truth + 1) % num_classes
    data = torch.from_numpy(clouds).to(dev)
    target = torch.from_numpy(labels.astype(np.int64)).to(dev)
    wb_fn = _surrogate_model_fn(args, num_classes, dev) if family in ("siadv", "simbapp", "si-query") else None

    gen = torch.Generator().manual_seed(args.seed)
    model = models.make_model(args.model, num_classes, generator=gen)
    state = load_checkpoint(args.checkpoint) if args.checkpoint else None
    if state is None:
        print(
            f"no --checkpoint: {args.model} weights drawn from seed {args.seed}",
            file=sys.stderr,
        )
    model_fn = _normalize_output(make_model_fn(model, state, dev), args.model)
    if args.defense != "none":
        from pointcloudattack_tpu_torch.attacks.evaluation import with_defense

        model_fn = with_defense(model_fn, args.defense, key=args.seed + 7, npoint=args.num_points,
                                dup_variables=dup_variables)

    noise_gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    adv, success, queries = _run_family(args, model_fn, data, target, noise_gen,
                                        torch.from_numpy(truth).to(dev), wb_fn or model_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    if family in ("aof", "taof"):
        # the reference's result bundle (Eval_AOF.py:245-259)
        os.makedirs(args.output_dir, exist_ok=True)
        np.savez(os.path.join(args.output_dir, f"{family}_results.npz"), test_pc=adv.detach().cpu().numpy(),
                 test_label=truth, target_label=labels)
    success = success.cpu().numpy()
    asr = float(success.mean())
    print(
        f"attack {family}: ASR {asr:.3f} "
        f"({int(success.sum())}/{len(success)}) in {dt:.1f}s"
    )
    summary = {
        "family": family, "model": args.model, "asr": asr,
        "wall_clock_s": dt, "n": int(len(success)), "device": str(dev),
    }
    if queries is not None:
        summary["mean_query_cost"] = float(queries.float().mean())
        print(f"mean query cost: {summary['mean_query_cost']:.1f}")
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
            adv.cpu().numpy(), truth, preds.cpu().numpy(),
        )

    shuf_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shuf = shuffle_robustness(model_fn, adv, target, shuf_gen, targeted=targeted)
    summary["shuffle_asr"] = shuf
    print(f"shuffle-robust ASR: {shuf:.3f}")
    if args.transfer_test and args.trans_model:
        mat = transfer_matrix(_transfer_panel(args, num_classes, dev), adv.detach(), target, targeted=targeted)
        summary["transfer_asr"] = mat
        print(f"transfer ASR: {mat}")

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
    p.add_argument("--binary_step", type=int, default=0,
                   help="cw, geoa3, geoa3-partial, aof, taof: 0 = the family's default (10; aof 2)")
    p.add_argument("--num_iter", type=int, default=0,
                   help="0 = the family's default (cw and geoa3 500, knn 2500, aof 200, siadv 50); "
                        "simba, simbapp: the loop's iteration cap (0 = 3 x 1024; si-query runs up to N)")
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
    p.add_argument("--attack_method", default="untarget", choices=["untarget", "target"],
                   help="target: attack --target_class (aof, taof and the SIadv families)")
    p.add_argument("--target_class", type=int, default=-1,
                   help="targeted mode: the target class (-1 = the class after the truth)")
    p.add_argument("--low_pass", type=int, default=100, help="aof, taof: low-frequency eigenvectors")
    p.add_argument("--aof_gamma", type=float, default=0.5,
                   help="aof, taof: blend of the full and the low-frequency loss (reference GAMMA)")
    p.add_argument("--step_size", type=float, default=0.07, help="SIadv families: the step (reference 0.07)")
    p.add_argument("--top5_attack", action="store_true",
                   help="SIadv families: success only once the target leaves the top 5")
    p.add_argument("--surrogate_model", default="",
                   choices=["", "PointNet", "PointNet++Ssg", "PointNet++Msg", "DGCNN", "CurveNet"],
                   help="siadv, simbapp, si-query: white-box surrogate (empty = the victim)")
    p.add_argument("--surrogate_checkpoint", default="", help="reference-layout .pth of --surrogate_model")
    p.add_argument("--kappa", type=float, default=30.0)
    p.add_argument("--budget", type=float, default=0.18)
    p.add_argument("--num_samples", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--save_adv", action="store_true")
    p.add_argument("--defense", default="none", choices=["none", "sor", "srs", "dupnet"],
                   help="pre-head on the victim for every family")
    p.add_argument("--defense_checkpoint", default="",
                   help="trained PU-Net weights for --defense dupnet: a reference-layout .pth state dict "
                        "(required: a random upsampler does not defend)")
    p.add_argument("--transfer_test", action="store_true", help="evaluate transfer ASR on --trans_model")
    p.add_argument("--trans_model", default="PointNet++Msg",
                   help="comma-separated transfer panel (a repeated name gets a #i suffix)")
    p.add_argument("--trans_checkpoint", default="",
                   help="comma-separated reference-layout .pth state dicts, paired positionally with --trans_model")
    p.set_defaults(fn=cmd_attack)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
