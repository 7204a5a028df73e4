"""rtjax_torch's command line (cli.py, __main__.py) and demo example, after
rtjax's test_cli_renders: in process with ``--device cpu``, plus one
subprocess ``python -m rtjax_torch --help`` that imports no JAX."""

import os
import subprocess
import sys

import pytest
import torch

from rtjax_torch import cli
from rtjax_torch.render.film import read_ppm

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SMALL = ["--scene", "cornell_planes", "--width", "16", "--height", "16",
         "--spp", "2", "--bounces", "2", "--pool", "512", "--device", "cpu"]


def test_cli_renders(tmp_path, capsys):
    out = tmp_path / "cli.ppm"
    assert cli.main(["render", *SMALL, "-o", str(out)]) == 0
    assert read_ppm(out).shape == (16, 16, 3)
    text = capsys.readouterr().out
    assert "wavefront iterations" in text and f"wrote {out}" in text


def test_cli_stats_and_checkpoint(tmp_path, capsys):
    out = tmp_path / "stats.ppm"
    assert cli.main(["render", *SMALL, "--stats", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "bounce histogram: [512, " in text and "node steps" in text
    ck = tmp_path / "ck.npz"
    out2 = tmp_path / "ck.ppm"
    assert cli.main(["render", *SMALL, "--checkpoint", str(ck),
                     "-o", str(out2)]) == 0
    assert ck.exists() and read_ppm(out2).shape == (16, 16, 3)


def test_cli_bench(capsys):
    assert cli.main(["bench", *SMALL, "--reps", "1"]) == 0
    assert "Mrays/s" in capsys.readouterr().out


@pytest.mark.parametrize("flag, err, item", [
    (["--sharded"], NotImplementedError, "Queue A 15"),
])
def test_cli_unported_options_raise(tmp_path, capsys, monkeypatch, flag, err,
                                    item):
    """``--sharded`` raised ``err`` naming ``item`` before multi-device
    rendering was ported; without torchrun's variables it now renders as
    a world of one (tests/test_torch_parallel.py runs two ranks)."""
    for v in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    out = tmp_path / "x.ppm"
    assert cli.main(["render", *SMALL, *flag, "-o", str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    assert read_ppm(out).shape == (16, 16, 3)


@pytest.mark.parametrize("flag", [["--traversal", "xla"], ["--no-sort"],
                                  ["--traversal", "pallas"]], ids=str)
def test_cli_traversal_and_sort_options_render(tmp_path, flag):
    out = tmp_path / "x.ppm"
    assert cli.main(["render", *SMALL, *flag, "-o", str(out)]) == 0
    img = read_ppm(out)
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["render", *args, "-o", str(tmp_path / "x.ppm")])


def test_module_help_imports_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['rtjax_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('rtjax_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or "
            "k == 'rtjax' or k.startswith('rtjax.') for k in sys.modules)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.rstrip().endswith("ok"), \
        res.stdout + res.stderr
    assert "render" in res.stdout and "bench" in res.stdout
    res = subprocess.run([sys.executable, "-m", "rtjax_torch", "--help"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "{render,bench}" in res.stdout


def test_example_renders_on_the_cpu(tmp_path, monkeypatch):
    """The demo example's main path at a smaller frame (its config
    patched), through the port."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "cornell_bunny_torch",
        os.path.join(REPO, "examples", "cornell_bunny_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = mod.RenderConfig
    monkeypatch.setattr(mod, "RenderConfig", lambda **kw: real(
        **dict(kw, width=8, height=8, num_samples=1, max_bounces=1,
               num_working_paths=256)))
    out = tmp_path / "demo.ppm"
    mod.main([str(out), "--device", "cpu"])
    assert read_ppm(out).shape == (8, 8, 3)
