"""The port's fault plans (``robust/faults.py``) against the JAX
package's, exactly: sampled plans byte for byte over several seeds and
specs, the zero and single-outage plans, step and chunk slices, the
event oracles, spec parsing (its errors too) and the history tag."""

import numpy as np
import pytest

from dmclock_tpu.robust import faults as JF
from dmclock_tpu_torch.robust import faults as TF

SPECS = [
    "seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1",
    "seed=3,p_dropout=0.2,mean_outage_steps=3,p_delay=0.3,max_skew_ns=5000",
    "seed=11,p_delay=0.5,p_dup=0.5",
    {"seed": 5, "p_dropout": 0.1, "max_skew_ns": 10},
    "p_dropout=1e-1",
]


def assert_plan_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for f, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
@pytest.mark.parametrize("steps,servers", [(12, 4), (40, 8)])
def test_sampled_plans_equal(spec, steps, servers):
    jp, tp = JF.parse_fault_spec(spec), TF.parse_fault_spec(spec)
    assert jp == tp
    a = JF.plan_from_spec(jp, steps, servers)
    b = TF.plan_from_spec(tp, steps, servers)
    assert_plan_equal(a, b)
    assert JF.plan_events(a) == TF.plan_events(b)
    ja, tb = JF.plan_shard_events(a), TF.plan_shard_events(b)
    assert ja.keys() == tb.keys()
    for key in ja:
        assert ja[key].dtype == tb[key].dtype
        assert np.array_equal(ja[key], tb[key])
    assert JF.describe(a) == TF.describe(b)
    for t in (0, steps // 2, steps - 1):
        assert_plan_equal(JF.plan_step(a, t), TF.plan_step(b, t))
    for e0, e1 in ((0, 4), (4, 8), (steps - 3, steps)):
        assert_plan_equal(JF.plan_chunk(a, e0, e1),
                          TF.plan_chunk(b, e0, e1))


def test_zero_and_single_outage():
    assert_plan_equal(JF.zero_plan(6, 3), TF.zero_plan(6, 3))
    assert TF.describe(TF.zero_plan(6, 3)) == "none"
    assert TF.describe(None) == JF.describe(None) == "none"
    kw = dict(server=2, down_from=1, down_until=4)
    a = JF.single_outage_plan(6, 3, **kw)
    b = TF.single_outage_plan(6, 3, **kw)
    assert_plan_equal(a, b)
    assert TF.plan_events(b) == {"server_dropouts": 1,
                                 "tracker_resyncs": 1,
                                 "faults_injected": 2}
    assert JF.describe(a) == TF.describe(b) == "T6xS3:drop1+resync1+inject2"
    assert_plan_equal(JF.sample_plan(9, 5, 2, p_dropout=0.3),
                      TF.sample_plan(9, 5, 2, p_dropout=0.3))


@pytest.mark.parametrize("label", [None, "", "none", "NONE", "chaos-run-3"])
def test_labels_parse_to_none(label):
    assert JF.parse_fault_spec(label) is None
    assert TF.parse_fault_spec(label) is None


@pytest.mark.parametrize("bad", ["seed=1,p_drop=0.1", {"p_typo": 1}])
def test_spec_errors_equal(bad):
    with pytest.raises(ValueError) as je:
        JF.parse_fault_spec(bad)
    with pytest.raises(ValueError) as te:
        TF.parse_fault_spec(bad)
    assert str(je.value) == str(te.value)
