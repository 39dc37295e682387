"""chip_smoke.py and bench.py: no CPU fallback, and the comparison helpers
the GPU phases rely on."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--multi"]),
                                         ("bench.py", [])])
def test_script_refuses_cpu_only_platform(script, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script), *args],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "GPU" in out.stderr
    for line in out.stdout.splitlines():  # no result line of any kind
        assert not line.startswith("{"), line


def test_check_operators_and_format():
    assert cs.Check("a", 1.0, "<=", 1.0).ok
    assert not cs.Check("a", 1.5, "<", 1.0).ok
    assert cs.Check("a", 2, ">", 1).ok
    assert cs.Check("a", True, "==", True).ok
    assert not cs.Check("a", 0.5, ">=", 1.0).ok
    assert str(cs.Check("x", 0.25, "<=", 1e-3)) == "x=0.25 (<= 0.001)"
    with pytest.raises(ValueError):
        cs.Check("a", 1, "~", 1)


def test_mc_check_is_the_3_sigma_rule():
    from light_transport_tpu.tally.stats import mc_parity_3sigma

    for est in (0.41, 0.414, 0.4155, 0.418, 0.42):
        c = cs.mc_check("rd", est, 0.4155, 5e-4, 1e-3)
        assert c.ok == mc_parity_3sigma(est, 0.4155, 5e-4, abs_floor=1e-3)


def test_image_stats():
    a = np.zeros((4, 4, 3))
    b = a.copy()
    b[0, 0, 0] = 0.5  # one flipped sample
    b[3, 1, 2] = 1e-4  # a last-bits difference
    st = cs.image_stats(a, b)
    assert st["max_err"] == 0.5
    assert np.isclose(st["mae"], (0.5 + 1e-4) / 48)
    assert np.isclose(st["mean_diff"], (0.5 + 1e-4) / 48)
    assert np.isclose(st["frac_px_over_1e-3"], 1 / 16)
    with pytest.raises(ValueError):
        cs.image_stats(a, np.zeros((4, 4)))


def test_hit_agreement_counts_mismatches_and_ties():
    t_a = np.array([1.0, 2.0, 3.0, np.inf, 5.0])
    t_b = np.array([1.0, 2.0 * (1 + 1e-7), 3.5, 4.0, 5.0])
    valid_a = np.array([True, True, True, False, True])
    valid_b = np.array([True, True, True, True, True])
    tri_a = np.array([0, 1, 2, -1, 7])
    tri_b = np.array([0, 9, 3, 4, 7])  # ray 1: tie, ray 2: real mismatch
    st = cs.hit_agreement(t_a, tri_a, valid_a, t_b, tri_b, valid_b)
    assert st["valid_mismatch"] == 1
    assert st["hits"] == 4
    assert np.isclose(st["t_max_rel_err"], 0.5 / 3.5)
    assert st["tri_mismatch_non_tie"] == 1


def test_random_rays_unit_and_in_box():
    o, d = cs.random_rays(0, 1000, (-1, 0, 2), (1, 3, 4))
    assert o.dtype == d.dtype == np.float32
    assert (o >= [-1, 0, 2]).all() and (o <= [1, 3, 4]).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    o2, _ = cs.random_rays(0, 1000, (-1, 0, 2), (1, 3, 4))
    np.testing.assert_array_equal(o, o2)  # same seed, same rays


def test_smoke_records_failed_and_raising_phases(capsys):
    smoke = cs.Smoke()
    smoke.phase("good", lambda: {"info": {"s": 1.5},
                                 "checks": [cs.Check("x", 1, "==", 1)]})
    smoke.phase("bad", lambda: {"checks": [cs.Check("x", 2, "==", 1)]})
    smoke.phase("raises", lambda: 1 / 0)
    assert smoke.failed == ["bad", "raises"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("phase good: ok=True")
    assert "s=1.5" in lines[0] and "x=1 (== 1)" in lines[0]
    assert lines[1].startswith("phase bad: ok=False")
    assert lines[2].startswith("phase raises: ok=False")
    assert not any(line.startswith("{") for line in lines)


def _unit_quad():
    # two triangles of the unit square in z=0, sharing the diagonal
    v0 = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    e1 = np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    e2 = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    return v0, e1, e2


@pytest.mark.parametrize("x,y,expected", [
    (0.5, 0.5, True),     # on the shared diagonal
    (0.25, 0.75, False),  # inside one triangle
    (0.5, 0.0, False),    # on an outer edge only one triangle has
    (2.0, 2.0, False),    # a miss
])
def test_shared_edge_rays(x, y, expected):
    o = np.array([[x, y, 1.0]])
    d = np.array([[0.0, 0.0, -1.0]])
    assert cs.shared_edge_rays(*_unit_quad(), o, d)[0] == expected


def test_shared_edge_rays_takes_the_nearest_hit():
    v0, e1, e2 = _unit_quad()
    # a third triangle in front of the quad's diagonal hides it
    v0 = np.vstack([v0, [[-1.0, -1.0, 0.5]]])
    e1 = np.vstack([e1, [[4.0, 0.0, 0.0]]])
    e2 = np.vstack([e2, [[0.0, 4.0, 0.0]]])
    o = np.array([[0.5, 0.5, 1.0]])
    d = np.array([[0.0, 0.0, -1.0]])
    assert not cs.shared_edge_rays(v0, e1, e2, o, d)[0]


def test_alloc_agreement():
    a = np.array([1, 1, 2, 0, 1])
    assert cs.alloc_agreement(a, a) == {"px_mismatch": 0, "cum_max_diff": 0}
    b = np.array([1, 2, 1, 0, 1])  # one sample moved one pixel over
    assert cs.alloc_agreement(a, b) == {"px_mismatch": 2, "cum_max_diff": 1}
    c = np.array([2, 1, 2, 0, 0])  # one sample moved four pixels over
    assert cs.alloc_agreement(a, c)["cum_max_diff"] == 1
    assert cs.alloc_agreement(a, c)["px_mismatch"] == 2
    with pytest.raises(ValueError):
        cs.alloc_agreement(a, a[:3])


def test_mean_and_stderr():
    m, se = cs.mean_and_stderr([1.0, 2.0, 3.0, 4.0])
    assert m == 2.5
    assert np.isclose(se, np.std([1, 2, 3, 4], ddof=1) / 2)
