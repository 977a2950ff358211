"""The roofline probes (c_raytracer_tpu_torch/tools/roofline.py) against
the JAX tool's (tools/profiling/roofline.py).

Each JAX probe is run with its timing replaced by a recorder and its
array constructors cut to ``SMALL`` elements, which hands back the probe's
own jitted jnp function; that function and the port's plain torch version
then run on the same seeded inputs:

* the stream (x·0.5 + 0.25, the scaling exact) and the division chain
  (IEEE adds and divides on both sides): bit-equal;
* the FMA chain: within rtol 1e-6 (8 ulp at float32): the port's plain
  version rounds each step once, through float64, as ``fmaf`` does, and
  XLA's CPU compiler may or may not contract y·a + b into one FMA;
* the sin and pow chains: within rtol 1e-6 (the two libraries' sinf and
  powf each round within an ulp, and 32 and 16 steps carry it on);
* the gather: its output indices exact, and the rows' sums of the plain
  version within rtol 1e-5 of numpy's (another summation order).

The printed lines carry the JAX probes' keys, and the rates follow from
the shapes by the JAX tool's formulas (roofline.py:59, :81, :164).  On
the CPU the kernel wrappers run the plain versions and count no launch.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.tools import roofline as port

JAX_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "profiling", "roofline.py")
SMALL = 4096


class _SmallArrays:
    """jax.numpy with the probes' array constructors cut to SMALL
    elements; everything else is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def zeros(shape, dtype):
        return jnp.zeros((SMALL,), dtype)

    @staticmethod
    def linspace(a, b, n, dtype):
        return jnp.linspace(a, b, SMALL, dtype=dtype)

    @staticmethod
    def full(shape, value, dtype):
        return jnp.full((SMALL,), value, dtype)


def _jax_probe(monkeypatch, capsys, name):
    """(the probe's jitted function, its input, its printed JSON line)."""
    spec = importlib.util.spec_from_file_location("jax_roofline", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}

    def record(fn, x, iters=10):
        got["fn"], got["x"] = fn, x
        return 1.0

    monkeypatch.setattr(mod, "timeit", record)
    monkeypatch.setattr(mod, "jnp", _SmallArrays())
    capsys.readouterr()
    getattr(mod, name)()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got["fn"], got["x"], line


def _inputs(op, seed=0):
    lo, hi = {"stream": (-4, 4), "fma": (0, 1), "sin": (0, 1),
              "pow": (0.1, 0.9), "div": (0.5, 2.5)}[op]
    return np.random.default_rng(seed).uniform(lo, hi, SMALL).astype(
        np.float32)


CHAINS = [("probe_vpu", "fma", port.FMA_K, 1e-6, port.probe_vpu),
          ("probe_trans", "sin", port.SIN_K, 1e-6, port.probe_trans),
          ("probe_pow", "pow", port.POW_K, 1e-6, port.probe_pow),
          ("probe_div", "div", port.DIV_K, 0.0, port.probe_div)]


def _port_line(probe, **kw):
    line = probe("cpu", **kw)
    line.update(device="cpu", card=None)
    return line


def test_stream_matches_jax(monkeypatch, capsys):
    fn, _, jline = _jax_probe(monkeypatch, capsys, "probe_hbm")
    x = _inputs("stream")
    np.testing.assert_array_equal(
        port.stream(torch.from_numpy(x)).numpy(), np.asarray(fn(x)))
    line = _port_line(port.probe_hbm, n=SMALL)
    assert set(jline) <= set(line)
    assert line["bytes_per_call"] == 2 * SMALL * 4 == port.stream_bytes(SMALL)
    assert line["achieved_GBps"] == pytest.approx(
        line["bytes_per_call"] / line["seconds"] / 1e9)
    assert line["peak_GBps"] is None and line["share_of_peak"] is None


@pytest.mark.parametrize("name,op,k,rtol,probe", CHAINS,
                         ids=[c[1] for c in CHAINS])
def test_chain_matches_jax(monkeypatch, capsys, name, op, k, rtol, probe):
    fn, x0, jline = _jax_probe(monkeypatch, capsys, name)
    # the probe's own starting array, and seeded inputs over its range
    for x in (np.array(x0), _inputs(op)):
        want = np.asarray(fn(x))
        got = port.chain(torch.from_numpy(x), op, k).numpy()
        if rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
        assert np.all(np.isfinite(got))
    line = _port_line(probe, n=SMALL)
    assert set(jline) <= set(line)
    rate = [v for key, v in line.items() if key.startswith("achieved_")][0]
    if op == "fma":
        assert line["flops_per_el"] == 2 * k
        assert rate == pytest.approx(
            port.fma_flops(SMALL, k) / line["seconds"] / 1e12)
        assert port.fma_flops(SMALL, k) == 2 * k * SMALL
    else:
        assert rate == pytest.approx(k * SMALL / line["seconds"] / 1e9)
        assert line[f"f32_ops_per_{op}"] is None


def test_gather_matches_jax(monkeypatch, capsys):
    np.random.seed(3)
    fn, idx0, jline = _jax_probe(monkeypatch, capsys, "probe_gather")
    np.random.seed(3)
    tbl = np.random.rand(port.GATHER_ROWS,
                         port.GATHER_F * port.GATHER_C).astype(np.float32)
    idx = np.array(idx0)
    out, sums = port.gather(torch.from_numpy(tbl), torch.from_numpy(idx),
                            with_sums=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(fn(idx)))
    np.testing.assert_array_equal(out.numpy(), idx)
    np.testing.assert_allclose(sums.numpy(), tbl[idx].sum(-1), rtol=1e-5)
    line = _port_line(port.probe_gather, r=SMALL)
    assert set(jline) <= set(line)
    assert (line["rows"], line["row_bytes"]) == (jline["rows"],
                                                 jline["row_bytes"])
    assert port.gather_bytes(SMALL, 13 * 64) == SMALL * 13 * 64 * 4
    assert line["achieved_GBps"] == pytest.approx(
        port.gather_bytes(SMALL, 13 * 64) / line["seconds"] / 1e9)
    assert line["peak_GBps"] is None and line["share_of_peak"] is None
    assert line["resident"] is None


def test_wrappers_on_cpu_run_the_plain_versions():
    before = (port.stream.launches, port.chain.launches,
              port.gather.launches)
    x = torch.from_numpy(_inputs("pow"))
    assert torch.equal(port.stream(x), port.stream_reference(x))
    assert torch.equal(port.chain(x, "pow", 3),
                       port.chain_reference(x, "pow", 3))
    tbl, idx = port.gather_inputs("cpu", rows=10, width=8, r=5)
    assert torch.equal(port.gather(tbl, idx), port.gather_reference(
        tbl, idx)[0])
    assert (port.stream.launches, port.chain.launches,
            port.gather.launches) == before
    with pytest.raises(ValueError, match="unknown chain op"):
        port.chain(x, "exp", 2)
    with pytest.raises(ValueError, match="contiguous"):
        port.stream(x.double())
