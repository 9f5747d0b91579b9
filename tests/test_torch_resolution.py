"""Compile-time resolution of the port's Runtime against the reference's:
``runtime.compile`` takes the ambient ``use_backend`` and
``use_quant_state`` when its arguments are not given (the counterparts of
``tests/test_runtime.py:268-283``); the Runtime's own state wins over
contexts a caller nests around an entry point; ``with_overrides`` takes
``quant_state=None`` literally inside a ``use_quant_state``
(``tests/test_runtime.py:314-318``); a ``PimContext`` built without a
``quant_state`` takes the ambient one and an explicit ``None`` none.
Each scenario runs through both packages."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core.quant_state import QuantState as JQuantState  # noqa: E402
from repro.core.quant_state import use_quant_state as j_use_qs  # noqa: E402
from repro.core.trq import make_params as j_make_params  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim import use_backend as j_use_backend  # noqa: E402
from repro.pim.plan import quant_state_token as j_token  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core import QuantState, make_params  # noqa: E402
from repro_torch.core import active_quant_state, use_quant_state  # noqa: E402
from repro_torch.core import quant_state as qs_core  # noqa: E402
from repro_torch.models.layers import PimContext  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.pim import active_quant_state as pim_active  # noqa: E402
from repro_torch.pim import use_backend  # noqa: E402
from repro_torch.pim import use_quant_state as pim_use_qs  # noqa: E402
from repro_torch.pim.plan import quant_state_token  # noqa: E402

KEY = jax.random.PRNGKey(0)
TINY = dict(remat="none", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
            d_ff=96, vocab_size=64, dtype="float32")


def _crush(make=make_params, cls=QuantState):
    """Registers degenerate enough to move fake_quant logits visibly."""
    return cls(rules=((r".", make(n_r1=1, n_r2=1, m=0, delta_r1=16.0,
                                  signed=True)),))


def _pair(backend="fake_quant"):
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(
        pim_backend=backend, **TINY)
    params = jbuild(jcfg)[0](KEY)
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend=backend, **TINY)
    flat = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, cfg, from_jax(flat, cfg)


def test_compile_inherits_ambient_backend_and_quant_state():
    jcfg, jparams, cfg, state = _pair()
    with j_use_backend("exact"):
        j_rt = jrt.compile(jcfg, jparams)
    with use_backend("exact"):
        rt = runtime.compile(cfg, state, device="cpu")
    assert j_rt.backend == rt.backend == "exact"
    jqs, qs = _crush(j_make_params, JQuantState), _crush()
    with j_use_qs(jqs):
        j_rt = jrt.compile(jcfg, jparams)
    with use_quant_state(qs):
        rt = runtime.compile(cfg, state, device="cpu")
    assert j_rt.quant_state is jqs and rt.quant_state is qs
    assert j_rt.plan.qs_token == j_token(jqs)
    assert rt.plan.qs_token == quant_state_token(qs)
    # the arguments win over the ambient contexts, in both
    with j_use_backend("exact"), j_use_qs(jqs):
        j_rt = jrt.compile(jcfg, jparams, backend="pallas")
    with use_backend("exact"), use_quant_state(qs):
        rt = runtime.compile(cfg, state, device="cpu", backend="pallas")
    assert j_rt.backend == rt.backend == "pallas"
    # no context: the config's backend, no registers
    rt = runtime.compile(cfg, state, device="cpu")
    assert rt.backend == "fake_quant" and rt.quant_state is None


def test_runtime_state_wins_over_contexts_nested_around_a_call():
    _, _, cfg, state = _pair()
    toks = np.random.default_rng(0).integers(0, 64, (1, 6)).astype(np.int32)
    rt = runtime.compile(cfg, state, device="cpu")
    (plain, _), rep = rt.prefill(toks, max_len=8)
    with use_backend("exact"), use_quant_state(_crush()):
        (ctx, _), rep_ctx = rt.prefill(toks, max_len=8)
        assert active_quant_state() is not None       # restored after
    assert torch.equal(plain, ctx) and int(rep.ad_ops) == int(rep_ctx.ad_ops)
    assert int(rep.ad_ops) > 0
    # and the ambient registers do reach a Runtime compiled inside them
    with use_quant_state(_crush()):
        rt_qs = runtime.compile(cfg, state, device="cpu")
    (crushed, _), _ = rt_qs.prefill(toks, max_len=8)
    assert not torch.equal(plain, crushed)


def test_with_overrides_quant_state_none_is_literal():
    jcfg, jparams, cfg, state = _pair()
    jqs, qs = _crush(j_make_params, JQuantState), _crush()
    j_rt = jrt.compile(jcfg, jparams).with_overrides(quant_state=jqs)
    rt = runtime.compile(cfg, state, device="cpu").with_overrides(
        quant_state=qs)
    with j_use_qs(jqs):
        j_cleared = j_rt.with_overrides(quant_state=None)
    with use_quant_state(qs):
        cleared = rt.with_overrides(quant_state=None)
    assert j_cleared.quant_state is None and j_cleared.plan.qs_token is None
    assert cleared.quant_state is None and cleared.plan.qs_token is None


def test_use_quant_state_nests_restores_and_ignores_none():
    a, b = _crush(), QuantState()
    assert active_quant_state() is None
    with use_quant_state(None):
        assert active_quant_state() is None
    with use_quant_state(a):
        with use_quant_state(None):
            assert active_quant_state() is a
        with use_quant_state(b):
            assert active_quant_state() is b
        assert active_quant_state() is a
    assert active_quant_state() is None
    assert pim_use_qs is use_quant_state and pim_active is active_quant_state
    assert qs_core._ACTIVE["qs"] is None


def test_pim_context_takes_the_ambient_quant_state_unless_given():
    cfg = get_config("llama3.2-3b", smoke=True)
    qs = _crush()
    with use_quant_state(qs):
        assert PimContext(cfg, "exact").quant_state is qs
        assert PimContext(cfg, "exact", None).quant_state is None
        other = QuantState()
        assert PimContext(cfg, "exact", other).quant_state is other
    assert PimContext(cfg, "exact").quant_state is None


def test_jax_reference_behaves_the_same_for_none():
    """The reference's ``use_quant_state(None)`` is the same no-op."""
    from repro.core.quant_state import active_quant_state as j_active
    jqs = _crush(j_make_params, JQuantState)
    with j_use_qs(jqs):
        with j_use_qs(None):
            assert j_active() is jqs
    assert j_active() is None
