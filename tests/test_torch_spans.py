"""The port's profiler spans (utils/spans.py): a shared no-op with no
profiler running; under a profiler that records user scopes alone, one
task-2 train step and one predict record each layer's span once and no
op; the runner's loader waits record a span each; and a train step's
results are bit-equal with the profiler on and off. Tiny Faster R-CNN on
the CPU."""
import json
import types

import torch

from nsgp_repre_tpu_torch import testing
from nsgp_repre_tpu_torch.engine import ewc, optim
from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner, build_teacher
from nsgp_repre_tpu_torch.engine.train import (TrainState, make_teacher_step, make_train_step,
                                               normalize_images)
from nsgp_repre_tpu_torch.models.detector import FasterRCNN
from nsgp_repre_tpu_torch.utils.spans import span

TRAIN_SPANS = ("train_step", "backbone", "rpn", "proposals", "roi", "replay", "ewc", "backward",
               "optimizer")
PREDICT_SPANS = ("predict", "backbone", "rpn", "proposals", "roi")


def _task2():
    """A task-2 student with its teacher, prototypes, drifted EWC terms and
    SGD-NSCL, the batch and the teacher's detections; the same each call."""
    model = FasterRCNN(testing.tiny_detector_config(task_id=2)).init_weights(
        torch.Generator().manual_seed(0))
    teacher = build_teacher(model)
    g = torch.Generator().manual_seed(1)
    params = dict(model.named_parameters())
    importance = {k: torch.rand(v.shape, generator=g) * 1e-3
                  for k, v in ewc.init_importance(params).items()}
    terms = {k: (imp, old + 0.01 * torch.randn(old.shape, generator=g))
             for k, (imp, old) in ewc.append_task_terms({}, importance, params).items()}
    opt = optim.sgd_nscl(list(model.named_parameters()), 0.01)
    state = TrainState(opt, teacher_params=dict(teacher.named_parameters()),
                       replay_feats=torch.randn((6, 256 * 49), generator=g),
                       replay_labels=torch.tensor([0, 1, 0, 1, 0, 1]), ewc_terms=terms)
    batch = testing.demo_det_batch(2, 64, 96, num_instances=(2, 3), num_classes=4, seed=2)
    with torch.no_grad():
        dets = make_teacher_step(teacher)(batch)
    return model, teacher, opt, state, batch, dets


def _train_step(setup):
    model, teacher, opt, state, batch, dets = setup
    step = make_train_step(model, opt, teacher_model=teacher)
    return step(state, batch, torch.Generator().manual_seed(3), teacher_dets=dets)[1]


def _user_scope_events(fn, tmp_path):
    """``fn()`` under the profiler with CPU activity restricted to user
    scopes; returns its result and the recorded complete events."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope,
                                    _ExperimentalConfig)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, {ProfilerActivity.CPU})
    _enable_profiler(config, {ProfilerActivity.CPU}, {RecordScope.USER_SCOPE})
    try:
        out = fn()
    finally:
        result = _disable_profiler()
    path = tmp_path / "trace.json"
    result.save(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return out, [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]


def _counts(events):
    """Occurrences of each program span; no op may be among the events
    (torch's own ``Optimizer.*`` scopes are user scopes too)."""
    assert not [e["name"] for e in events if e["name"].startswith("aten::")]
    out = {}
    for e in events:
        if e["name"].startswith("nsgp."):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("backbone") is span("optimizer")
    with span("backbone") as got:
        assert got is None


def test_train_step_and_predict_record_each_layer_span_once(tmp_path):
    setup = _task2()
    _, events = _user_scope_events(lambda: _train_step(setup), tmp_path)
    assert _counts(events) == {"nsgp." + s: 1 for s in TRAIN_SPANS}
    at = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
          if e["name"].startswith("nsgp.")}
    step = at["nsgp.train_step"]
    assert all(step[0] <= a and b <= step[1] for a, b in at.values())
    roi, replay = at["nsgp.roi"], at["nsgp.replay"]
    assert roi[0] <= replay[0] and replay[1] <= roi[1]
    # backward and the optimizer come after the loss's spans
    assert at["nsgp.ewc"][1] <= at["nsgp.backward"][0] <= at["nsgp.optimizer"][0]

    model, batch = setup[0], setup[4]
    model.eval()
    _, events = _user_scope_events(
        lambda: model.predict(batch.replace(images=normalize_images(batch.images))), tmp_path)
    assert _counts(events) == {"nsgp." + s: 1 for s in PREDICT_SPANS}


def test_runner_loader_waits_record_a_span_each(tmp_path):
    runner = types.SimpleNamespace(timings={})
    runner._add = lambda key, value: NullSpaceRunner._add(runner, key, value)
    items, events = _user_scope_events(
        lambda: list(NullSpaceRunner._timed(runner, iter("abc"), "loader_wait_s")), tmp_path)
    assert items == ["a", "b", "c"] and runner.timings["loader_wait_s"] > 0
    # one wait per item, and the one that finds the loader done
    assert _counts(events) == {"nsgp.runner.loader_wait": 4}


def test_train_step_is_bit_equal_with_the_profiler_on(tmp_path):
    off, on = _task2(), _task2()
    m_off = _train_step(off)
    m_on, _ = _user_scope_events(lambda: _train_step(on), tmp_path)
    assert set(m_off) == set(m_on) and "ewc_loss" in m_on and "replay_loss_cls" in m_on
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for (n, a), (_, b) in zip(off[0].named_parameters(), on[0].named_parameters()):
        assert torch.equal(a, b), n
