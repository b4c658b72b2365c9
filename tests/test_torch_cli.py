"""The port's entry points end to end on the synthetic ROUGH sequence, as
``tests/test_cli.py`` drives the JAX scripts: ``python -m
monoforce_tpu_torch.scripts.{train,run,eval,explore_data} ... --device cpu``
in subprocesses with their real ``sys.argv``; the ``--img-paths`` inputs
against the JAX ``scripts/run.py``'s on the same files; and without a card
every entry point that touches a device (the scripts and the examples)
raises unless it is given ``--device cpu``; the host-only examples take
no ``--device``."""

import glob
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import make_sequence, tiny_lss_cfg
from monoforce_tpu_torch.config import LSSConfig
from monoforce_tpu_torch.scripts import eval as eval_script
from monoforce_tpu_torch.scripts import explore_data, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = ("camera_left", "camera_front", "camera_right", "camera_rear")


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_data"))
    seq = make_sequence(root, n_frames=4)
    lss = tiny_lss_cfg()
    cfg_path = str(tmp_path_factory.mktemp("cfg") / "tiny_lss.yaml")
    LSSConfig(data_aug_conf=lss["data_aug_conf"], grid_conf=lss["grid_conf"],
              soft_classes=lss["soft_classes"]).to_yaml(cfg_path)
    return root, seq, cfg_path


def _run(script, argv, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", f"monoforce_tpu_torch.scripts.{script}",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def trained(cli_env, tmp_path_factory):
    root, _, cfg_path = cli_env
    log_dir = str(tmp_path_factory.mktemp("train") / "run")
    r = _run("train", ["--data_dir", root, "--bsz", "2", "--nepochs", "1",
                       "--robot", "tradr", "--traj_sim_time", "0.5",
                       "--lr", "1e-3", "--lss_cfg_path", cfg_path,
                       "--log_dir", log_dir, "--debug", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    return log_dir


def test_train_cli(trained):
    recs = [json.loads(line)
            for line in open(os.path.join(trained, "metrics.jsonl"))]
    assert any(r["split"] == "train" for r in recs)
    assert any(r["split"] == "val" for r in recs)
    assert all(np.isfinite(v) for r in recs for k, v in r.items()
               if k.startswith(("iter_loss", "epoch_loss")))
    names = os.listdir(trained)
    for name in ("dphys_cfg.yaml", "lss_cfg.yaml", "train_best.pth",
                 "val_best.pth"):
        assert name in names, names


def test_run_cli_from_checkpoint(cli_env, trained, tmp_path):
    _, seq, cfg_path = cli_env
    out = str(tmp_path / "run.png")
    r = _run("run", ["--seq_dir", seq, "--index", "1", "--checkpoint",
                     os.path.join(trained, "train_best.pth"),
                     "--lss_cfg_path", cfg_path, "--n_trajs", "16",
                     "--out", out, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "best path:" in r.stdout and os.path.exists(out)
    # the load is strict: a checkpoint with a key too many is refused
    sd = torch.load(os.path.join(trained, "train_best.pth"))
    sd["extra"] = torch.zeros(1)
    bad = str(tmp_path / "bad.pth")
    torch.save(sd, bad)
    r = _run("run", ["--seq_dir", seq, "--checkpoint", bad,
                     "--lss_cfg_path", cfg_path, "--n_trajs", "16",
                     "--out", out, "--device", "cpu"])
    assert r.returncode != 0 and "extra" in r.stderr


def test_checkpoint_formats(trained, tmp_path):
    """A Trainer's .pth state_dict and a full .pt checkpoint give the same
    encoder weights."""
    from monoforce_tpu_torch.training.trainer import read_state_dict

    pth = os.path.join(trained, "train_best.pth")
    sd = torch.load(pth)
    full = str(tmp_path / "full.pt")
    torch.save({"model": sd, "optimizer": {}, "step": 1}, full)
    for path in (pth, full):
        got = read_state_dict(path)
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)


def _jax_run_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_script", os.path.join(REPO, "scripts", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_img_paths_inputs_match_jax(cli_env, tmp_path, capsys):
    """--img-paths mode: the inputs equal the JAX script's on the same
    files, and the whole tick runs."""
    from monoforce_tpu.config import LSSConfig as JaxLSSConfig

    _, seq, cfg_path = cli_env
    paths = [sorted(glob.glob(os.path.join(seq, "images", f"*_{c}.png")))[0]
             for c in CAMS]
    calib = os.path.join(seq, "calibration")
    jax_run = _jax_run_script()
    # named cameras, and the calibration's cameras in sorted order
    for cams in (list(CAMS), None):
        got = run._inputs_from_images(paths, calib, cams,
                                      LSSConfig.from_yaml(cfg_path))
        want = jax_run._inputs_from_images(paths, calib, cams,
                                           JaxLSSConfig.from_yaml(cfg_path))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(SystemExit):
        run._inputs_from_images(paths[:3], calib, list(CAMS),
                                LSSConfig.from_yaml(cfg_path))
    terrain, plan = run.main(["--img-paths", *paths, "--calibration-path",
                              calib, "--cameras", *CAMS, "--lss_cfg_path",
                              cfg_path, "--n_trajs", "16", "--out",
                              str(tmp_path / "img.png"), "--device", "cpu"])
    assert "best path:" in capsys.readouterr().out
    assert plan.xs.shape[0] == 16 and bool(torch.isfinite(plan.costs).all())


def test_eval_cli(cli_env, trained, tmp_path):
    root, _, cfg_path = cli_env
    out_dir = str(tmp_path / "eval")
    r = _run("eval", ["--data_dir", root, "--robot", "tradr",
                      "--traj_sim_time", "0.5", "--bsz", "1",
                      "--checkpoint", os.path.join(trained, "val_best.pth"),
                      "--lss_cfg_path", cfg_path, "--out_dir", out_dir,
                      "--save_figures", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = open(os.path.join(out_dir, "losses.csv")).read().splitlines()
    # one val sample of the 4-frame sequence (the 10% split keeps one)
    assert lines[0] == "batch,hm_geom,hm_terrain,traj_xyz,traj_rot"
    assert len(lines) == 2
    assert all(np.isfinite(float(v)) for v in lines[1].split(",")[1:])
    assert os.path.exists(os.path.join(out_dir, "batch_0000.png"))
    assert "hm_geom" in r.stdout


def test_explore_data_cli(cli_env, tmp_path):
    _, seq, _ = cli_env
    out = str(tmp_path / "sample.png")
    r = _run("explore_data", ["--seq_dir", seq, "--index", "2", "--out", out,
                              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "4 samples" in r.stdout and os.path.exists(out)


def test_figures_without_matplotlib(cli_env, tmp_path, monkeypatch, capsys):
    """Without matplotlib (an optional dependency), run skips its figure,
    and the entry points whose output is a figure say what is missing."""
    root, seq, cfg_path = cli_env
    for mod in (run, eval_script, explore_data):
        monkeypatch.setattr(mod, "have_matplotlib", lambda: False)
    out = str(tmp_path / "none.png")
    run.main(["--seq_dir", seq, "--lss_cfg_path", cfg_path, "--n_trajs",
              "16", "--out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "best path:" in text and "not written" in text
    assert not os.path.exists(out)
    with pytest.raises(SystemExit, match="matplotlib"):
        explore_data.main(["--seq_dir", seq, "--device", "cpu"])
    with pytest.raises(SystemExit, match="matplotlib"):
        eval_script.main(["--data_dir", root, "--save_figures", "--device",
                          "cpu"])


@pytest.mark.parametrize("script", [
    "train", "eval", "run", "explore_data", "fit_terrain",
    "robot_control motion", "robot_control shoot", "navigate",
    "examples.diff_physics", "examples.train_friction_head",
    "examples.inference_with_rough_data"])
def test_entry_points_need_the_card(cli_env, script):
    """Without a card, the default device raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    root, seq, _ = cli_env
    name, *argv = script.split()
    if name in ("train", "eval"):
        argv = ["--data_dir", root]
    elif name in ("run", "explore_data"):
        argv = ["--seq_dir", seq]
    elif name == "examples.inference_with_rough_data":
        argv = ["--sequence", seq]
    package = "examples" if name.startswith("examples.") else "scripts"
    mod = importlib.import_module(
        f"monoforce_tpu_torch.{package}.{name.split('.')[-1]}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("name", ["explore_data", "explore_robot_contacts",
                                  "rgbd_data"])
def test_host_examples_need_no_card(cli_env, tmp_path, name, capsys):
    """The host-only examples take no ``--device`` and run without a
    card."""
    _, seq, cfg_path = cli_env
    mod = importlib.import_module(f"monoforce_tpu_torch.examples.{name}")
    argv = ["--out", str(tmp_path / f"{name}.png")]
    if name == "explore_data":
        argv += ["--sequence", seq, "--lss_cfg_path", cfg_path]
    with pytest.raises(SystemExit):
        mod.main([*argv, "--device", "cpu"])
    assert "unrecognized arguments: --device" in capsys.readouterr().err
    assert mod.main(argv) is not None
