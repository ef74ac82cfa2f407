"""The port's replay and sweep viewers (`viz/replay.py`,
`viz/interactive.py`) against the JAX package's on the same trajectory.

Neither machine has `rerun`, so the fallbacks are the path held here:
`replay_trajectory`'s quat-pos `.npy` and `replay_urdf`'s `.npy` and scene
JSON equal the JAX functions' files (1e-12; the JSON exactly), as do
`load_urdf`'s geometry and link poses, `_rpy_matrix` and
`_matrix_quat_xyzw` (1e-12).  The trajectory comes as a float32 tensor
too (cast to float64 on the host: 1e-6 against the float64 files).  The
sweep viewers build and scrub headless under Agg, and write the animation;
importing `viz.interactive` loads no matplotlib.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.viz import replay as jreplay
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep as tsweep
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB
from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import interactive
from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import replay

URDF = """<?xml version="1.0"?>
<robot name="testbot">
  <link name="base">
    <visual>
      <origin xyz="0.1 0 0" rpy="0 0 0"/>
      <geometry><box size="0.2 0.3 0.4"/></geometry>
    </visual>
  </link>
  <link name="arm">
    <visual>
      <origin xyz="0 0.5 0" rpy="0.3 -0.2 0.9"/>
      <geometry><cylinder radius="0.05" length="1.0"/></geometry>
    </visual>
  </link>
  <link name="tip">
    <visual>
      <geometry><sphere radius="0.1"/></geometry>
    </visual>
    <visual>
      <geometry>
        <mesh filename="package://meshes/ball.obj" scale="2 2 2"/>
      </geometry>
    </visual>
  </link>
  <joint name="j1" type="fixed">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="1 0 0" rpy="0 0 1.5707963267948966"/>
  </joint>
  <joint name="j2" type="fixed">
    <parent link="arm"/>
    <child link="tip"/>
    <origin xyz="2 0 0" rpy="0.1 0.2 0.3"/>
  </joint>
</robot>
"""


def _traj(T=12):
    """An SE(3) trajectory whose rotation passes angles near pi (the
    quaternion extraction's other branches)."""
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((T + 1, 6)) * np.linspace(0.1, 3.1, T + 1)[:, None]
    return np.array(jse3.exp(jnp.asarray(xi)))


@pytest.fixture
def urdf(tmp_path):
    p = tmp_path / "testbot.urdf"
    p.write_text(URDF)
    return str(p)


def test_replay_trajectory_fallback_matches_jax(tmp_path):
    qs = _traj()
    a = replay.replay_trajectory(torch.as_tensor(qs), dt=0.1, fallback_path=str(tmp_path / "t.npy"))
    b = jreplay.replay_trajectory(qs, dt=0.1, fallback_path=str(tmp_path / "j.npy"))
    assert a == str(tmp_path / "t.npy") and b == str(tmp_path / "j.npy")
    np.testing.assert_allclose(np.load(a), np.load(b), rtol=0, atol=1e-12)
    f32 = replay.replay_trajectory(torch.as_tensor(qs, dtype=torch.float32), dt=0.1,
                                   fallback_path=str(tmp_path / "f.npy"))
    np.testing.assert_allclose(np.load(f32), np.load(b), rtol=0, atol=1e-6)
    assert replay.replay_trajectory(qs, dt=0.1) is None


def test_load_urdf_matches_jax(urdf):
    a, b = replay.load_urdf(urdf), jreplay.load_urdf(urdf)
    assert a["name"] == b["name"] == "testbot"
    assert [j["name"] for j in a["joints"]] == [j["name"] for j in b["joints"]]
    for name in b["links"]:
        assert len(a["links"][name]) == len(b["links"][name])
        for va, vb in zip(a["links"][name], b["links"][name]):
            assert va["geometry"] == vb["geometry"]
            np.testing.assert_allclose(va["origin_R"], vb["origin_R"], rtol=0, atol=1e-12)
            np.testing.assert_allclose(va["origin_xyz"], vb["origin_xyz"], rtol=0, atol=1e-12)
        for x, y in zip(a["link_T"][name], b["link_T"][name]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    assert a["links"]["tip"][1]["geometry"]["filename"].endswith("meshes/ball.obj")


def test_replay_urdf_fallback_matches_jax(tmp_path, urdf):
    qs = _traj()
    a = replay.replay_urdf(urdf, torch.as_tensor(qs), dt=0.1, fallback_path=str(tmp_path / "t"))
    b = jreplay.replay_urdf(urdf, qs, dt=0.1, fallback_path=str(tmp_path / "j"))
    assert (a, b) == (str(tmp_path / "t"), str(tmp_path / "j"))
    assert (json.loads((tmp_path / "t.scene.json").read_text())
            == json.loads((tmp_path / "j.scene.json").read_text()))
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"),
                               rtol=0, atol=1e-12)
    assert replay.replay_urdf(urdf, qs, dt=0.1) is None


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(1)
    for rpy in rng.uniform(-3.0, 3.0, size=(6, 3)):
        R = replay._rpy_matrix(rpy)
        np.testing.assert_allclose(R, jreplay._rpy_matrix(rpy), rtol=0, atol=1e-12)
        np.testing.assert_allclose(replay._matrix_quat_xyzw(R), jreplay._matrix_quat_xyzw(R),
                                   rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def sweeps():
    dyn, dp, bq0, bxi0, _ = EB.build_rollout_sweep(device="cpu")
    ranges = {"w_z": np.asarray([0.5, 1.0, 1.5])}
    roll = tsweep.run_rollout_sweep(dyn, dp, ranges, bq0, bxi0, N=20)["w_z"]
    rng = np.random.default_rng(2)
    solved = tsweep.SweepResult(param="v_x", values=np.asarray([1.0, 2.0, 3.0]),
                                J_opt=np.asarray([3.0, 2.0, 5.0]), grad_norm=np.ones(3),
                                converged=np.ones(3, bool), us=rng.standard_normal((3, 20, 6)))
    return roll, solved


def test_viewers_build_and_scrub_headless(sweeps, tmp_path):
    import matplotlib.pyplot as plt

    roll, solved = sweeps
    fig, slider, update = interactive.rollout_slider(roll, q_ref=roll.qs[0])
    update(2)
    line = fig.axes[0].lines[-1]
    np.testing.assert_allclose(line.get_data_3d()[0], roll.qs[2, :, 0, 3])
    assert slider.valmax == 2
    plt.close(fig)
    fig, slider, update = interactive.sweep_slider(solved)
    update(1)
    np.testing.assert_allclose(fig.axes[0].lines[0].get_ydata(),
                               np.linalg.norm(solved.us[1], axis=-1))
    plt.close(fig)
    path = interactive.rollout_animation(roll, str(tmp_path / "roll.gif"), fps=5)
    assert (tmp_path / "roll.gif").stat().st_size > 0 and path.endswith("roll.gif")


def test_importing_the_viewers_loads_no_matplotlib():
    code = ("import sys\n"
            "import trajectory_optimization_matrix_lie_groups_tpu_torch.viz.interactive\n"
            "import trajectory_optimization_matrix_lie_groups_tpu_torch.viz.replay\n"
            "sys.exit(int(any(m.startswith('matplotlib') for m in sys.modules)))\n")
    from test_torch_port_imports import ROOT

    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
