"""Port of the CW attack (pointcloudattack_tpu_torch/attacks) and its CLI
against the JAX package.

``build_cw_attack`` of both packages runs on the same exported PointNet
weights and the same init noise (jax.random and torch draw different
streams, so the test draws the JAX engine's noise and hands it to the
port): ``success`` identical, ``best_dist`` rtol 1e-4, ``best_attack``
atol 1e-5.  Everything here runs on the CPU.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks.cw import (
    CWPerturbConfig as JCWPerturbConfig,
    build_cw_attack as j_build_cw_attack,
)
from pointcloudattack_tpu.attacks.engine import transfer_check as j_transfer_check
from pointcloudattack_tpu.data.synthetic import make_synthetic_clouds as j_make_synthetic_clouds
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
from pointcloudattack_tpu_torch.attacks.engine import shuffle_check, transfer_check
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import NUM_CLASSES, NUM_POINTS, perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def victim():
    """(jax model_fn, port model_fn, reference-layout state dict)."""
    jm = jmodels.make_model("PointNet", NUM_CLASSES)
    v = jmodels.init_model(jm, jax.random.PRNGKey(3), num_points=NUM_POINTS, batch=2)
    v = perturb(v, np.random.RandomState(3))
    sd = state_dict_from_flax("PointNet", v)
    fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), sd, "cpu")
    return j_make_model_fn(jm, v), fn, sd


def attack_inputs(b=4):
    """Clouds and labels.  With the ``victim`` fixture and lr 0.05, cloud 0 (its
    clean prediction is its label) flips in the middle of the attack, 1 and
    2 are misclassified from the start, and 3 resists 10 steps."""
    rng = np.random.RandomState(11)
    data = (rng.randn(b, NUM_POINTS, 3) * 0.5).astype(np.float32)
    target = np.array([2, 1, 2, 0])[:b]
    return data, target


@pytest.mark.parametrize("binary_step,num_iter", [(1, 10), (2, 5)])
def test_build_cw_attack_matches_jax(victim, binary_step, num_iter):
    jfn, fn, _ = victim
    data, target = attack_inputs()
    kw = dict(binary_step=binary_step, num_iter=num_iter, kappa=30.0, budget=0.18,
              attack_lr=0.05)
    key = jax.random.PRNGKey(7)
    want = j_build_cw_attack(jfn, JCWPerturbConfig(**kw))(
        jnp.asarray(data), jnp.asarray(target), key
    )
    # the JAX engine's per-round noise, unscaled (engine.py: split, normal)
    noise = np.stack([
        np.asarray(jax.random.normal(k, data.shape, jnp.float32))
        for k in jax.random.split(key, binary_step)
    ])
    cm.reset_launches()
    got = build_cw_attack(fn, CWPerturbConfig(**kw))(
        torch.from_numpy(data), torch.from_numpy(target), init_noise=torch.from_numpy(noise)
    )
    assert cm.LAUNCHES == {"fwd": 0, "bwd": 0}
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.best_dist.numpy(), np.asarray(want.best_dist), rtol=1e-4)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.final_pred.numpy(), np.asarray(want.final_pred))
    assert got.success.float().mean() > 0
    # a real best distance, found mid-attack, was compared
    assert 0.01 < float(got.best_dist[0]) < 1e9


def test_engine_noise_comes_from_the_generator(victim):
    _, fn, _ = victim
    data, target = attack_inputs(2)
    run = build_cw_attack(fn, CWPerturbConfig(binary_step=1, num_iter=3))
    d, t = torch.from_numpy(data), torch.from_numpy(target)
    a = run(d, t, generator=torch.Generator().manual_seed(1))
    b = run(d, t, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.best_attack, b.best_attack)
    with pytest.raises(ValueError, match="init_noise"):
        run(d, t, init_noise=torch.zeros(2, 2, NUM_POINTS, 3))


def test_shuffle_and_transfer_checks(victim):
    jfn, fn, _ = victim
    data, target = attack_inputs()
    x, t = torch.from_numpy(data), torch.from_numpy(target)
    plain = fn(x).argmax(-1) != t
    # PointNet is invariant to the order of the points
    assert torch.equal(shuffle_check(fn, x, t, torch.Generator().manual_seed(0)), plain)
    got = transfer_check(fn, x, t)
    assert torch.equal(got, plain)
    want = j_transfer_check(jfn, jnp.asarray(data), jnp.asarray(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_attack_cw_on_cpu(victim, tmp_path, capsys):
    _, _, sd = victim
    ckpt = tmp_path / "pointnet.pth"
    torch.save(sd, ckpt)
    out = tmp_path / "out"
    asr = cli_main([
        "attack", "cw", "--dataset", "synthetic", "--model", "PointNet",
        "--num_points", str(NUM_POINTS), "--num_classes", str(NUM_CLASSES),
        "--checkpoint", str(ckpt), "--binary_step", "1", "--num_iter", "5",
        "--kappa", "30", "--budget", "0.18", "--num_samples", "4", "--seed", "0",
        "--device", "cpu", "--output_dir", str(out), "--save_adv",
    ])
    printed = capsys.readouterr().out
    assert f"attack cw: ASR {asr:.3f}" in printed
    assert "MSE " in printed and "Chamfer " in printed and "Hausdorff " in printed
    summary = json.loads((out / "attack_cw_summary.json").read_text())
    assert summary["family"] == "cw" and summary["n"] == 4 and summary["asr"] == asr
    assert summary["device"] == "cpu" and np.isfinite(summary["chamfer"])
    dumps = sorted((out / "AdvData" / "PointNet").glob("cw_*_label*_pred*.txt"))
    assert len(dumps) == 4
    assert np.loadtxt(dumps[0]).shape == (NUM_POINTS, 3)


def test_cli_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    argv = ["attack", "cw", "--num_points", "16", "--num_classes", "3",
            "--num_iter", "1", "--binary_step", "1", "--output_dir", str(tmp_path)]
    for extra in ([], ["--device", "cuda"]):  # cuda is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(argv + extra)
    assert not (tmp_path / "attack_cw_summary.json").exists()


@pytest.mark.parametrize("args", [(40, 2, 1024, 0), (3, 5, 64, 7), (1, 1, 16, 2)])
def test_synthetic_clouds_match_jax_package(args):
    clouds, labels = make_synthetic_clouds(*args)
    want_clouds, want_labels = j_make_synthetic_clouds(*args)
    assert clouds.dtype == want_clouds.dtype == np.float32
    assert labels.dtype == want_labels.dtype == np.int32
    np.testing.assert_array_equal(clouds, want_clouds)
    np.testing.assert_array_equal(labels, want_labels)


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    roots = {m.split(".")[0] for m in imported}
    assert "pointcloudattack_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "pointcloudattack_tpu"}, sorted(imported)


def test_port_imports_no_jax():
    modules = [
        "pointcloudattack_tpu_torch",
        "pointcloudattack_tpu_torch.data.synthetic",
        "pointcloudattack_tpu_torch.ops._build",
        "pointcloudattack_tpu_torch.ops.chain_maxpool",
        "pointcloudattack_tpu_torch.ops.pairwise",
        "pointcloudattack_tpu_torch.ops.gather",
        "pointcloudattack_tpu_torch.ops.fps",
        "pointcloudattack_tpu_torch.ops.ball_query",
        "pointcloudattack_tpu_torch.ops.grouping",
        "pointcloudattack_tpu_torch.ops.gather_chain",
        "pointcloudattack_tpu_torch.ops.knn",
        "pointcloudattack_tpu_torch.ops.chamfer",
        "pointcloudattack_tpu_torch.ops.kappa",
        "pointcloudattack_tpu_torch.ops.group_chain",
        "pointcloudattack_tpu_torch.geometry.eig3",
        "pointcloudattack_tpu_torch.geometry.normals",
        "pointcloudattack_tpu_torch.attacks.geoa3",
        "pointcloudattack_tpu_torch.models",
        "pointcloudattack_tpu_torch.models.dgcnn",
        "pointcloudattack_tpu_torch.models.curvenet",
        "pointcloudattack_tpu_torch.losses.geometry",
        "pointcloudattack_tpu_torch.attacks.knn",
        "pointcloudattack_tpu_torch.models.common",
        "pointcloudattack_tpu_torch.models.pointnet",
        "pointcloudattack_tpu_torch.models.pointnet2",
        "pointcloudattack_tpu_torch.losses.adv",
        "pointcloudattack_tpu_torch.losses.distance",
        "pointcloudattack_tpu_torch.constraints.clip",
        "pointcloudattack_tpu_torch.attacks.engine",
        "pointcloudattack_tpu_torch.attacks.cw",
        "pointcloudattack_tpu_torch.utils.apply",
        "pointcloudattack_tpu_torch.train.weights",
        "pointcloudattack_tpu_torch.cli.main",
    ]
    code = (
        "import importlib, sys\n"
        "assert 'jax' not in sys.modules\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pointcloudattack_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
