"""hymba and xLSTM training on a ("data", "model") mesh of gloo ranks
against the single-device step, with the gates and the runner of
``tests/test_torch_sharded_training.py`` (the single-device quantized
values replayed on each rank).

On a "model" axis the SSD, mLSTM and sLSTM scans run on the rank's heads
(``models/ssm.py`` and ``models/xlstm.py`` say which leaf goes which
way): reduced hymba (4 query heads on 1 KV head) and xLSTM on (1, 2) and
(2, 2) ``2d``, FSDP off and on, and hymba on (1, 4); hymba with a d_ff of
129, which no "model" axis divides (JAX's spec leaves the FFN's split
dimension whole: the FFN runs whole on every rank, as full-width hymba's
5504 on five ranks), also under sequence parallelism; xLSTM under
sequence parallelism.
"""

import pytest

from test_torch_sharded_training import (
    _case, _run, check_against_the_single_device_step)

HY, XL = "hymba-1.5b", "xlstm-350m"

CASES_2 = [
    _case("hymba (1, 2) 2d", HY, [1, 2]),
    _case("hymba (1, 2) 2d fsdp", HY, [1, 2], fsdp=True),
    _case("xlstm (1, 2) 2d", XL, [1, 2]),
    _case("xlstm (1, 2) 2d fsdp", XL, [1, 2], fsdp=True),
    _case("hymba d_ff 129 (1, 2) 2d", HY, [1, 2], cfg=dict(d_ff=129)),
    _case("hymba d_ff 129 (1, 2) 2d sp", HY, [1, 2], cfg=dict(d_ff=129),
          sp=True),
    _case("xlstm (1, 2) 2d sp", XL, [1, 2], sp=True),
]
CASES_4 = [
    _case("hymba (2, 2) 2d", HY, [2, 2]),
    _case("hymba (2, 2) 2d fsdp", HY, [2, 2], fsdp=True),
    _case("xlstm (2, 2) 2d", XL, [2, 2]),
    _case("xlstm (2, 2) 2d fsdp", XL, [2, 2], fsdp=True),
    _case("hymba (1, 4) 2d", HY, [1, 4]),
]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {**_run(tmp_path_factory, CASES_2, 2),
            **_run(tmp_path_factory, CASES_4, 4)}


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4])
def test_recurrent_step_on_a_model_axis_matches_the_single_device_step(
        results, case):
    check_against_the_single_device_step(results[case])
