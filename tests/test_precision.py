"""Every float32 contraction whose result is data asks for full precision.

On a GPU an f32 ``dot_general`` at the default precision may run in TF32
(about three decimal digits).  These tests read the jaxpr of each such
site and require ``Precision.HIGHEST`` on every ``dot_general`` in it, so a
dropped ``precision=`` shows here on the CPU, where the numbers alone
cannot show it.
"""
import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

MECH = """
ELEMENTS
H O N
END
SPECIES
H O2 OH O HO2 H2O N2
END
REACTIONS CAL/MOLE
H + O2 => OH + O          2.0E14 0.0  16000.
H + O2 + M => HO2 + M     6.0E17 -0.8 0.
  H2O/6.0/ N2/1.0/
OH + OH (+M) => H2O + O (+M)  1.0E13 0.0 0.
  LOW / 1.0E16 0.0 0.0 /
  TROE / 0.6 100.0 1000.0 /
END
"""


def _dot_precisions(jaxpr):
    """The ``precision`` param of every dot_general in ``jaxpr`` and its
    sub-jaxprs (scan, while, pjit, cond bodies)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _assert_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dot_general traced: the site moved"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in p), precs


def _stats_case():
    from peleanalysis_tpu.ops.stats import binned_stats
    v = jnp.linspace(0.0, 1.0, 4 * 5 * 6, dtype=jnp.float32).reshape(4, 5, 6)
    m = jnp.ones((4, 5, 6), bool)
    return (lambda a, b: binned_stats(a, b[None], 1.0, m, 0.0, 1.0, 8),
            v, v * 2)


def _jpdf_case():
    from peleanalysis_tpu.ops.stats import joint_pdf
    v = jnp.linspace(0.0, 1.0, 60, dtype=jnp.float32).reshape(3, 4, 5)
    m = jnp.ones((3, 4, 5), bool)
    return (lambda a, b: joint_pdf(a, b, 1.0, m, 0.0, 1.0, 0.0, 2.0, 8),
            v, 2 * v)


def _jpdf_multi_case():
    from peleanalysis_tpu.ops.stats import joint_pdf_multi
    v = jnp.linspace(0.0, 1.0, 3 * 60, dtype=jnp.float32).reshape(3, 3, 4, 5)
    m = jnp.ones((3, 4, 5), bool)
    lo, hi = jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32)
    return (lambda a: joint_pdf_multi(a, 1.0, m, lo, hi, 8,
                                      ((0, 1), (1, 2))), v)


def _stoich_case():
    from peleanalysis_tpu.tools.jpdf import stoichiometry_field

    class _DS:      # the two attributes stoichiometry_field reads
        names = ["A", "B"]
        meta = type("M", (), {"n_levels": 1})()

        def __init__(self, d):
            self.data = [d]

        def comp(self, n):
            return self.names.index(n)

    v = jnp.linspace(0.1, 1.0, 2 * 24, dtype=jnp.float32).reshape(2, 2, 3, 4)
    return (lambda d: stoichiometry_field(_DS(d), ["A", "B"], [2, 0],
                                          [0, 1])[0], v)


def _kinetics_case(tmp_path):
    from peleanalysis_tpu.chem.kinetics import Kinetics, parse_chemkin
    p = tmp_path / "mech.inp"
    p.write_text(MECH)
    sp, rxns, _ = parse_chemkin(str(p))
    kin = Kinetics(sp, rxns)
    T = jnp.full((4,), 1500.0, jnp.float32)
    X = jnp.full((4, 7), 1.0 / 7, jnp.float32)
    rho = jnp.full((4,), 1e-4, jnp.float32)
    return (lambda t, x, r: kin.qf_qr_from_state(t, r, x, xp=jnp),
            T, X, rho)


def _trace_case():
    from peleanalysis_tpu.stream.trace import _trace_level
    vec = jnp.ones((3, 6, 6, 6), jnp.float32)
    seeds = jnp.full((4, 3), 0.5, jnp.float32)
    dx = jnp.full((3,), 0.2, jnp.float32)
    return (lambda v, s: _trace_level(v, v[:0], jnp.zeros(3, jnp.float32),
                                      dx, 0.05, s, 3,
                                      jnp.ones((4, 1), jnp.float32)),
            vec, seeds)


@pytest.mark.parametrize("site", ["stats_binned", "stats_jpdf",
                                  "stats_jpdf_multi", "jpdf_stoichiometry",
                                  "kinetics_qf_qr", "stream_trilinear"])
def test_contraction_precision_highest(site, tmp_path):
    case = {"stats_binned": _stats_case, "stats_jpdf": _jpdf_case,
            "stats_jpdf_multi": _jpdf_multi_case,
            "jpdf_stoichiometry": _stoich_case,
            "kinetics_qf_qr": lambda: _kinetics_case(tmp_path),
            "stream_trilinear": _trace_case}[site]()
    _assert_highest(*case)


def test_precision_check_sees_default_precision():
    """The checker itself fails on a default-precision contraction."""
    a = jnp.ones((4, 4), jnp.float32)
    with pytest.raises(AssertionError):
        _assert_highest(lambda x: x @ x, a)
    _assert_highest(lambda x: jnp.matmul(
        x, x, precision=jax.lax.Precision.HIGHEST), a)
    assert np.isfinite(float(jnp.sum(a)))
