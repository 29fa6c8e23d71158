"""The port's Algorithm 1 train step at M = 4 against a step composed from
JAX functions only: section (b) of ``tests/test_torch_train_step.py``,
whose module doc states the step, the codecs and the criteria (helpers in
``tests/torch_train_step_common.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from torch_train_step_common import (  # noqa: E402
    STEPS,
    CODEC_STEPS,
    CODECS,
    _port_step,
    _free_running_losses,
    _check_teacher_forced,
    M4,
    MICRO,
    _composed_run,
    _composed_count_run,
    _m4_count_cfgs,
)


# ---------------------------------------------------------------------------
# (b) M = 4 against a step composed from JAX functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_m4():
    return _composed_run("sign1bit", STEPS)


@pytest.fixture(scope="module", params=CODECS)
def ref_m4_codec(request):
    return request.param, _composed_run(request.param, CODEC_STEPS)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_teacher_forced_step_matches_composed_reference(ref_m4, step):
    states, losses, batches = ref_m4
    port = _port_step(M4, states[step], batches[step], step,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port)


def test_m4_free_running_losses_match_composed_reference(ref_m4):
    states, losses, batches = ref_m4
    got = _free_running_losses(M4, states[0], batches)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_codec_teacher_forced_step_matches_composed_reference(
        ref_m4_codec, step):
    codec, (states, losses, batches) = ref_m4_codec
    port = _port_step(M4, states[step], batches[step], step, codec,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, codec=codec)


def test_m4_codec_free_running_losses_match_composed_reference(ref_m4_codec):
    codec, (states, losses, batches) = ref_m4_codec
    got = _free_running_losses(M4, states[0], batches, codec)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


# ---------------------------------------------------------------------------
# (d) at M = 4: the count wire with microbatches against the composed step
#     (section (d) of tests/test_torch_train_step.py states its criteria)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MICRO)
def ref_m4_micro(request):
    jt, _ = _m4_count_cfgs(request.param)
    return request.param, _composed_count_run(jt, 3)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_microbatched_count_wire_step_matches_composed_reference(
        ref_m4_micro, step):
    micro, (states, losses, batches) = ref_m4_micro
    _, tt = _m4_count_cfgs(micro)
    port = _port_step(M4, states[step], batches[step], step, tcfg=tt,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


def test_m4_microbatched_free_running_losses_match_composed_reference(
        ref_m4_micro):
    micro, (states, losses, batches) = ref_m4_micro
    _, tt = _m4_count_cfgs(micro)
    got = _free_running_losses(M4, states[0], batches, tcfg=tt)
    np.testing.assert_allclose(got, losses, rtol=1e-3)
