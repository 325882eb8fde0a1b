"""Unit tests for the small utility subsystems."""

import io

from hast_jax.utils.checkpoint import step, step_done, mark_done
from hast_jax.utils.profiling import PhaseTimer


def test_checkpoint_roundtrip(tmp_path):
    wd = str(tmp_path)
    assert not step_done("x", wd)
    with step("x", wd) as todo:
        assert todo
    assert step_done("x", wd)
    ran = False
    with step("x", wd) as todo:
        if todo:
            ran = True
    assert not ran


def test_checkpoint_not_marked_on_error(tmp_path):
    wd = str(tmp_path)
    try:
        with step("y", wd) as todo:
            assert todo
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert not step_done("y", wd)


def test_phase_timer_report():
    log = io.StringIO()
    t = PhaseTimer(log=log)
    with t.phase("work", items=100):
        pass
    rep = t.report()
    assert "work" in rep and rep["work"]["items"] == 100
    assert "work" in log.getvalue()


def test_notice_fallback_once(capsys):
    """A demoted fast path logs exactly once per process per site
   ."""
    from hast_jax.utils import profiling as P

    P._FALLBACKS_SEEN.discard("unit-test-site")
    P.notice_fallback("unit-test-site", RuntimeError("boom"))
    P.notice_fallback("unit-test-site", RuntimeError("boom"))
    err = capsys.readouterr().err
    assert err.count("unit-test-site") == 1
    assert "boom" in err


def test_pack_acc_fetch_tiers():
    import numpy as np
    """The tally fetch tries uint8 -> uint16 -> raw int32 images; each
    tier must round-trip exactly at its boundary."""
    import jax.numpy as jnp
    from hast_jax.pipeline import classify as C

    for vals in ([0, 1, 255], [0, 256, 90], [70000, 2, 1], [0, 0, 0]):
        acc = jnp.asarray(
            np.array([vals, [1, 2, 3]], np.int32))
        got = C._fetch_acc_finish(C._fetch_acc_start(acc))
        np.testing.assert_array_equal(
            got, np.array([vals, [1, 2, 3]], np.int64))
