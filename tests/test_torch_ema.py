"""The self-training EMA teacher's float32 arithmetic where its two terms
cancel: the port's ``train/self_train.ema_update`` against the JAX
package's expression, both against float64.

The JAX EMA is a lambda inside its step
(``thermal_semantic_segmentation_tpu/train/self_train.py:249-252``,
``e * ema_decay + q * (1.0 - ema_decay)``), so ``jax_ema`` below copies it
verbatim under ``jax.jit``.

Near a parameter's zero (a BatchNorm bias that starts at 0 and moves by
lr 1e-6 a step), ``0.999 e`` and ``0.001 q`` nearly cancel: with ``q =
-999 e (1 + d)`` the result is ``-0.999 e d``, whose float32 ulp is some
``|d|`` times either term's. Each package rounds the two terms (or a term
and a fused sum) in float32, so both are off by about one ulp of the
larger term, which is thousands of ulps of the result. The test shows
that (the fault, in both packages) and the bound that does hold: within
``TERM_ULPS`` ulps of the largest of |kept|, |added| and |want|, and the
port within ``TERM_ULPS`` such ulps of JAX (their orders of rounding
differ).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thermal_semantic_segmentation_torch.train.self_train import (  # noqa: E402,E501
    ema_update)

DECAY = 0.999            # the self-training CLI's EMA decay
TERM_ULPS = 2.0          # chip_smoke.py's EMA_ULPS, in ulps of the largest term
N_ORDINARY, N_CANCEL = 4096, 4096


@jax.jit
def jax_ema(e, q):
    ema_decay = DECAY
    return jax.tree.map(lambda e, q: e * ema_decay + q * (1.0 - ema_decay),
                        e, q)


def teacher_and_student():
    """float32 (teacher, student, cancelling mask): ordinary elements (both
    ~N(0, 0.05), as a trained conv weight), and elements near 0 where
    ``q = -999 e (1 + d)``, |d| <= 1e-3, |e| ~ 1e-8."""
    rng = np.random.default_rng(1858)
    e_ord = rng.normal(0, 0.05, N_ORDINARY)
    q_ord = e_ord + rng.normal(0, 1e-4, N_ORDINARY)
    e_can = rng.choice([-1.0, 1.0], N_CANCEL) * 10 ** rng.uniform(
        -9, -7, N_CANCEL)
    d = rng.uniform(-1e-3, 1e-3, N_CANCEL)
    q_can = -999.0 * e_can * (1.0 + d)
    e = np.concatenate([e_ord, e_can]).astype(np.float32)
    q = np.concatenate([q_ord, q_can]).astype(np.float32)
    cancel = np.arange(e.size) >= N_ORDINARY
    return e, q, cancel


def ulps(err, of):
    return np.abs(err) / np.spacing(np.abs(of).astype(np.float32)).astype(
        np.float64)


@pytest.fixture(scope="module")
def readings():
    e, q, cancel = teacher_and_student()
    port = torch.from_numpy(e.copy())
    ema_update([port], [torch.from_numpy(q)], DECAY)
    port = port.numpy().astype(np.float64)
    jx = np.asarray(jax_ema(jnp.asarray(e), jnp.asarray(q))).astype(
        np.float64)
    kept = DECAY * e.astype(np.float64)
    added = (1.0 - DECAY) * q.astype(np.float64)
    want = kept + added
    largest = np.maximum(np.maximum(np.abs(kept), np.abs(added)),
                         np.abs(want))
    return {"port": port, "jax": jx, "want": want, "largest": largest,
            "cancel": cancel}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_cancelling_elements_read_past_two_ulps_of_the_result(readings,
                                                              package):
    """The fault: at the cancelling elements both packages are thousands of
    ulps of the float64 result away from it."""
    r = readings
    got = ulps(r[package] - r["want"], r["want"])[r["cancel"]]
    print(f"{package}: worst {got.max():.4g} result-ulps at the cancelling "
          f"elements, {np.mean(got > TERM_ULPS):.3f} of them past "
          f"{TERM_ULPS}")
    assert got.max() > 100 * TERM_ULPS
    assert np.mean(got > TERM_ULPS) > 0.5


@pytest.mark.parametrize("package", ["port", "jax"])
def test_every_element_within_two_ulps_of_the_largest_term(readings,
                                                          package):
    """The bound that holds, at ordinary and cancelling elements alike."""
    r = readings
    got = ulps(r[package] - r["want"], r["largest"])
    print(f"{package}: worst {got.max():.4g} ulps of the largest term")
    assert got.max() <= TERM_ULPS


def test_port_within_two_term_ulps_of_jax(readings):
    r = readings
    got = ulps(r["port"] - r["jax"], r["largest"])
    print(f"port vs JAX: worst {got.max():.4g} ulps of the largest term")
    assert got.max() <= TERM_ULPS


def test_ordinary_elements_within_two_ulps_of_the_result(readings):
    """Away from cancellation the result's ulp is the terms' and the
    result-ulp bound holds, as the chip check read it on most runs."""
    r = readings
    for package in ("port", "jax"):
        got = ulps(r[package] - r["want"], r["want"])[~r["cancel"]]
        assert got.max() <= TERM_ULPS, package
