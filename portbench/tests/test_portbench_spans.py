"""The span metrics (layer_ms, gap_ms, launches) on a hand-built span
stretch, and the span stretch recorded on the CPU."""
import pytest
import torch

from portbench import common
from portbench.spans import SpanStretch, middle, reduce, span_stretch
from portbench.trace import Traced

STEPS = 2
# microseconds; replay nests in roi, every layer in the train step
SPANS = [("nsgp.train_step", 0, 100), ("nsgp.backbone", 10, 35), ("nsgp.roi", 40, 70),
         ("nsgp.replay", 50, 60), ("nsgp.optimizer", 80, 95), ("portbench.step", 0, 101)]
# (runtime call start, device op name, device op start, end): each call launches one op
LAUNCHES = [(12, "k1", 20, 30), (42, "k2", 45, 55), (52, "k3", 58, 62),
            (75, "Memcpy HtoD (Pageable -> Device)", 76, 78), (82, "k5", 85, 90),
            (105, "k6", 107, 110), (120, "k7", 125, 127)]


def stretch() -> SpanStretch:
    st = SpanStretch(steps=STEPS, window_s=130e-6)
    st.host = [(n, s, e, 1) for n, s, e in SPANS]
    for corr, (t, name, s, e) in enumerate(LAUNCHES):
        st.runtime.append((t, t + 1, corr))
        st.device.append((name, s, e, corr))
        if not name.startswith("Memcpy"):  # a copy's call is no kernel launch
            st.launch_calls.append((t, corr))
    return st


def per_step(us: float) -> float:
    return us / 1e3 / STEPS


def test_layer_ms_counts_nested_spans_in_their_parent():
    st = stretch()
    assert st.layer_ms("backbone") == pytest.approx(per_step(10))
    assert st.layer_ms("roi") == pytest.approx(per_step(10 + 4))
    assert st.layer_ms("replay") == pytest.approx(per_step(4))
    assert st.layer_ms("optimizer") == pytest.approx(per_step(5))


def test_gap_ms_takes_the_innermost_span_at_the_gap_start():
    st = stretch()
    want = {"backbone": 15, "replay": 3, "roi": 14, "step": 7, "optimizer": 17, "outside": 15}
    for k, v in want.items():
        assert st.gap_ms(k) == pytest.approx(per_step(v)), k


def test_gap_ms_variants_sum_to_the_inter_op_idle():
    st = stretch()
    got = sum(st.gap_ms(k) for k in ("backbone", "rpn", "proposals", "roi", "replay", "ewc",
                                      "backward", "optimizer", "step", "outside")
              if st.gap_ms(k) is not None)
    assert got == pytest.approx(1e3 * (st.span_s() - st.busy_s()) / STEPS)
    assert st.summary()["gap_ms_per_step"] == pytest.approx(
        {k: st.gap_ms(k) for k in ("backbone", "replay", "roi", "step", "optimizer", "outside")})


def test_launches_count_the_launch_calls_inside_a_span():
    st = stretch()
    assert st.kernel_launches("roi") == 2 / STEPS
    assert st.kernel_launches("replay") == 1 / STEPS
    assert st.kernel_launches("step") == 4 / STEPS  # the copy is no launch; k6, k7 are outside
    st.device = [d for d in st.device if d[0] != "k2"]  # a kernel the trace lost
    assert st.kernel_launches("roi") == 2 / STEPS and st.summary()["kernels_missing"] == 1


def test_a_missing_span_reads_none():
    st = stretch()
    assert st.layer_ms("ewc") is None and st.gap_ms("ewc") is None
    assert st.kernel_launches("ewc") is None
    st.host = [h for h in st.host if not h[0].startswith("nsgp.")]  # a program without spans
    assert st.gap_ms("outside") is None and st.layer_ms("roi") is None
    st = stretch()
    st.device = []  # a stretch without device activity (a CPU run) reads nothing
    assert st.layer_ms("roi") is None and st.gap_ms("outside") is None
    assert span_stretch(None, None) is None


def test_summary_shares_and_counts():
    s = stretch().summary()
    # launched under no layer span: the copy in the step glue, k6 and k7
    assert s["unattributed_share"] == pytest.approx((2 + 3 + 2) / 36)
    assert s["spans"]["nsgp.roi"] == 1 and s["aten_ops"] == 0
    assert s["launch_calls"] == 6 and s["kernels_missing"] == 0


def test_reduce_reads_a_chrome_trace():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "nsgp.roi", "ts": 0, "dur": 10, "tid": 3},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 3, "dur": 1,
         "args": {"correlation": 10}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 4, "dur": 2, "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nsgp.roi", "ts": 4, "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 4},
    ]
    st = reduce(events, 1, 1e-5)
    assert st.host == [("nsgp.roi", 0.0, 10.0, 3)]
    assert st.runtime == [(1.0, 2.0, 9), (3.0, 4.0, 10)]
    assert st.launch_calls == [(1.0, 9), (3.0, 10)]
    assert st.device == [("k", 4.0, 6.0, 9)]
    assert st.layer_ms("roi") == pytest.approx(2e-3)


def test_middle_cuts_the_first_and_last_step_away():
    st = SpanStretch(steps=4, window_s=0.0)
    for k in range(4):  # step k: a span, one launch, one kernel
        t = 100.0 * k
        st.host += [("portbench.step", t, t + 90, 1), ("nsgp.roi", t + 10, t + 50, 1)]
        st.runtime.append((t + 20, t + 21, k))
        st.launch_calls.append((t + 20, k))
        st.device.append((f"k{k}", t + 30, t + 60, k))
    got = middle(st, 2)
    assert got.steps == 2 and got.window_s == pytest.approx(190e-6)
    assert [d[0] for d in got.device] == ["k1", "k2"] and len(got.launch_calls) == 2
    assert sum(h[0] == "nsgp.roi" for h in got.host) == 2
    assert got.layer_ms("roi") == pytest.approx(30e-3)


def test_record_keeps_spans_and_no_ops_and_is_cached():
    from nsgp_repre_tpu_torch.utils.spans import span

    def step():
        with span("backbone"):
            x = torch.ones(8)
            for _ in range(20):
                x = x * 1.5 + 1
        with span("optimizer"):
            x.sum()

    traced = Traced(device=SpanStretch(steps=3, window_s=1.0), hosted=None)
    entry = type("E", (), {"step": staticmethod(step), "sync": staticmethod(lambda: None)})
    st = span_stretch(traced, entry)
    assert st is span_stretch(traced, entry)
    names = [h[0] for h in st.host]
    assert sorted(set(names)) == ["nsgp.backbone", "nsgp.optimizer", "portbench.step"]
    assert all(names.count(n) == 3 for n in set(names)) and st.steps == 3


def test_span_readers_load_by_name():
    for q in ("layer_ms", "gap_ms", "launches"):
        reader = common.load_module("metrics", q)
        assert reader.UNIT and reader.read(None, None, "roi") is None
