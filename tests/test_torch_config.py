"""The PyTorch port's config twin equals the JAX package's, field by field,
and the port never imports jax."""

import dataclasses
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import pytest
import torch

import plasma_control_tpu.config as jcfg
import plasma_control_tpu_torch.config as tcfg

torch.set_num_threads(1)

CLASSES = ["SimConfig", "ControlConfig", "MPCConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.default == b.default, a.name
        assert a.type == b.type, a.name


@pytest.mark.parametrize("kw", [
    {},
    dict(simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0),
    dict(n_particles=100, dt=0.5, t_max=7.3, t_min=0.2),  # CFL clamp, ceil
])
def test_sim_properties_match(kw):
    a, b = tcfg.SimConfig(**kw), jcfg.SimConfig(**kw)
    assert (a.dx, a.n_steps, a.cfl_dt, a.clamped_dt()) == (b.dx, b.n_steps, b.cfl_dt, b.clamped_dt())
    assert tcfg.ControlConfig(max_mode=4).n_actions == jcfg.ControlConfig(max_mode=4).n_actions


@pytest.mark.parametrize("kw", [
    dict(plan_correction="twin", n_grad_iters=2),
    dict(terminal_steps=-1),
])
def test_mpc_post_init_rejects_like_jax(kw):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.MPCConfig(**kw)


def test_mpc_post_init_warns_like_jax():
    for mod in (jcfg, tcfg):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            mod.MPCConfig(terminal_mode="growth", horizon=1)
        assert any("growth" in str(w.message) for w in got)


def test_port_never_imports_jax():
    """A fresh interpreter (this process has jax loaded by conftest) imports
    every module of the port and finds no jax in sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import plasma_control_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 15, names
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "plasma_control_tpu.")))
        assert not bad, bad
        print("ok", len(names))
    """)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
