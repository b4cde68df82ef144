"""The program's spans (``utils.profiling.span`` and ``recording``), on
the CPU: off, a span is one shared null object and records nothing; on,
each span keeps its name, its tag (the root's, inherited) and its host
times, and calls ``on_edge`` at both edges; one recorder is installed at
a time; under ``trace()`` the spans are ranges of the Chrome trace. The
documented span tree of each instrumented call, read from its edges,
whose outputs are bit-identical with a recorder installed and without.
``flag_measurement_set``'s ``timings=`` stays per call."""

import json
import threading

import numpy as np
import pytest
import torch

from rfi_toolbox_tpu_torch.io import flag_measurement_set, flag_waterfalls, make_fake_ms
from rfi_toolbox_tpu_torch.io import inject_synthetic_data
from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.preprocess import Preprocessor
from rfi_toolbox_tpu_torch.serving import CompiledPredictor
from rfi_toolbox_tpu_torch.train import create_train_state, train_steps
from rfi_toolbox_tpu_torch.utils import profiling
from rfi_toolbox_tpu_torch.utils.profiling import recording, span, trace

P = 32


class _Edges:
    """An ``on_edge`` keeping every edge with its thread; :meth:`tree` is
    the span tree they describe."""

    def __init__(self):
        self.edges = []  # (thread, name, tag)

    def __call__(self, name, tag):
        self.edges.append((threading.get_ident(), name, tag))

    def tree(self):
        """[(name, enclosing span's name)] in opening order; every span
        closed, after every span it encloses."""
        stacks, tree = {}, []
        for thread, name, tag in self.edges:
            stack = stacks.setdefault(thread, [])
            if stack and stack[-1] == (name, tag):
                stack.pop()
            else:
                tree.append((name, stack[-1][0] if stack else None))
                stack.append((name, tag))
        assert not any(stacks.values())
        return tree


# -- the recorder ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flag.call", "train.step", "anything"])
def test_off_a_span_is_the_shared_null_object(name):
    assert profiling._recorder is None
    s = span(name)
    assert s is profiling._NULL and s is span("other")
    with s as got:
        assert got is None
    with recording() as rec:
        pass
    assert rec.spans == [] and profiling._recorder is None


def test_spans_nest_and_inherit_the_root_tag():
    edges = _Edges()
    with recording(on_edge=edges) as rec:
        with span("a"):
            with span("a.b"):
                with span("a.b.c"):
                    pass
            with span("a.d"):
                pass
        with span("a"):
            pass
    first, ab, abc, ad, second = rec.spans
    assert [s.name for s in rec.spans] == ["a", "a.b", "a.b.c", "a.d", "a"]
    assert edges.tree() == [("a", None), ("a.b", "a"), ("a.b.c", "a.b"), ("a.d", "a"),
                            ("a", None)]
    assert ab.tag == abc.tag == ad.tag == first.tag != second.tag
    assert int(second.tag) > int(first.tag)
    assert first.start <= ab.start <= abc.start <= abc.end <= ab.end <= ad.start
    assert ad.end <= first.end <= second.start <= second.end
    assert all(s.seconds >= 0 for s in rec.spans)
    t, u = first.tag, second.tag
    assert [(n, g) for _, n, g in edges.edges] == [
        ("a", t), ("a.b", t), ("a.b.c", t), ("a.b.c", t), ("a.b", t), ("a.d", t),
        ("a.d", t), ("a", t), ("a", u), ("a", u)]


def test_an_exception_closes_its_spans():
    edges = _Edges()
    with recording(on_edge=edges) as rec:
        with pytest.raises(KeyError):
            with span("outer"):
                with span("inner"):
                    raise KeyError("x")
        with span("after"):
            pass
    assert all(s.end is not None for s in rec.spans)
    assert [n for _, n, _ in edges.edges] == ["outer", "inner", "inner", "outer", "after",
                                               "after"]
    # the stack was unwound: 'after' is a root, a request of its own
    assert edges.tree()[2] == ("after", None) and rec.spans[2].tag != rec.spans[0].tag


def _enter_on_another_thread(cm):
    raised = []

    def other():
        try:
            with cm():
                pass
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    if raised:
        raise raised[0]


SECOND = {
    "same_thread": lambda tmp: recording().__enter__(),
    "other_thread": lambda tmp: _enter_on_another_thread(recording),
    "trace": lambda tmp: _enter_on_another_thread(lambda: trace(tmp)),
}


@pytest.mark.parametrize("second", list(SECOND))
def test_a_second_recorder_is_refused(second, tmp_path):
    with recording() as rec:
        with pytest.raises(RuntimeError, match="already installed"):
            SECOND[second](tmp_path)
        assert profiling._recorder is rec
        with span("still"):
            pass
    assert profiling._recorder is None
    assert [s.name for s in rec.spans] == ["still"]


def test_spans_of_threads_keep_their_own_parents():
    edges, done = _Edges(), []

    def work():
        with span("worker"):
            done.append(1)

    with recording(on_edge=edges) as rec:
        with span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    assert dict(edges.tree()) == {"main": None, "worker": None} and done == [1]
    main, worker = rec.spans
    assert main.tag != worker.tag


def test_under_trace_the_spans_are_ranges_of_the_chrome_trace(tmp_path):
    wf = _waterfalls()
    with trace(tmp_path / "prof"):
        flag_waterfalls(wf, method="mad", patch_size=P, device="cpu")
    assert profiling._recorder is None
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"flag.call", "flag.patchify", "flag.mad", "flag.unpatchify"} <= names


# -- the instrumented calls --------------------------------------------------------------


def _waterfalls(seed=0, m=2, side=64):
    g = torch.Generator().manual_seed(seed)
    amp = torch.rand((m, side, side), generator=g) + 0.5
    amp[:, 9:12, :] += 40.0  # a channel stripe
    phase = torch.rand((m, side, side), generator=g) * 6.28
    return torch.polar(amp, phase)


def _mad():
    return (flag_waterfalls(_waterfalls(), method="mad", patch_size=P, device="cpu"),)


def _model():
    torch.manual_seed(0)
    model = UNet(init_features=4, norm="batch").eval()
    pred = CompiledPredictor(model, input_shape=(P, P, 3), batch_size=4, device="cpu")
    return (flag_waterfalls(_waterfalls(), method="model", patch_size=P, predictor=pred,
                            device="cpu"),)


def _static_prep():
    wf = _waterfalls()
    mask = (wf.abs() > 20).numpy()
    ds = Preprocessor(wf.numpy(), flags=mask, device="cpu").create_dataset(
        patch_size=P, use_custom_flags=True, seed=3, static_num_patches=24)
    return ds.images, ds.labels


def _train():
    torch.manual_seed(0)
    state = create_train_state(UNet(init_features=4), 1, device="cpu")
    g = torch.Generator().manual_seed(2)
    images = torch.rand((2, 2, 16, 16, 3), generator=g)
    labels = (torch.rand((2, 2, 16, 16), generator=g) > 0.7).to(torch.uint8)
    _, losses = train_steps(state, images, labels)
    return (losses, *[p.detach().clone() for p in state.params])


FLAG = [("flag.call", None), ("flag.patchify", "flag.call")]
STEP = [("train.step", None), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")]
CASES = {
    "mad": (_mad, FLAG + [("flag.mad", "flag.call"), ("flag.unpatchify", "flag.call")]),
    # 8 patches of 32 through a predictor of batch 4: two forwards, each by
    # the folded UNet's k6a_nhwc route
    "model": (_model, FLAG + [("flag.extract", "flag.call"), ("flag.predict", "flag.call"),
                              ("predict", "flag.predict"), ("predict.logits", "predict"),
                              ("predict.nhwc", "predict.logits"),
                              ("predict.logits", "predict"),
                              ("predict.nhwc", "predict.logits"),
                              ("flag.unpatchify", "flag.call")]),
    "static_prep": (_static_prep, [("prep.base", None), ("prep.select", None),
                                   ("prep.extract", None)]),
    "train_steps": (_train, STEP + STEP),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_span_tree_of_each_call(case):
    run, want = CASES[case]
    edges = _Edges()
    with recording(on_edge=edges) as rec:
        run()
    assert edges.tree() == want
    assert [s.name for s in rec.spans] == [name for name, _ in want]
    tags, root = [], None
    for s, (_, parent) in zip(rec.spans, want):
        if parent is None:
            root = s.tag
            tags.append(root)
        assert s.tag == root
    assert len(set(tags)) == len(tags)  # each root a request of its own
    assert all(s.end is not None and s.end >= s.start for s in rec.spans)


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_are_bit_identical_with_a_recorder(case):
    run, _ = CASES[case]
    off = run()
    with recording(on_edge=lambda name, tag: None):
        on = run()
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- flag_measurement_set's stages ---------------------------------------------------------


def _fake_ms(ntime=16):
    rng = np.random.default_rng(0)
    vis = rng.normal(1.0, 0.1, (3, 4, 32, ntime)) * np.exp(1j * rng.uniform(0, 6, (3, 4, 32,
                                                                                 ntime)))
    ms = make_fake_ms(num_antennas=3, channels_per_spw=(32,), num_times=ntime, seed=None)
    inject_synthetic_data(ms, vis, output_ms_path=ms)
    return ms


STAGES = {"load", "to_card", "card", "to_host", "save"}


@pytest.mark.parametrize("streaming", [False, True], ids=["bulk", "streaming"])
def test_timings_are_timed_inside_the_stage_spans(streaming):
    timings, edges = {}, _Edges()
    with recording(on_edge=edges) as rec:
        flag_measurement_set(_fake_ms(), patch_size=16, device="cpu", streaming=streaming,
                             timings=timings)
    stages = {}
    for s in rec.spans:
        if s.name.startswith("ms."):
            stages[s.name[3:]] = stages.get(s.name[3:], 0.0) + s.seconds
    assert set(timings) == set(stages) == STAGES
    assert all(0 < timings[k] <= stages[k] for k in STAGES)
    tree = edges.tree()
    assert all(parent is None for name, parent in tree if name.startswith("ms."))
    calls = [parent for name, parent in tree if name == "flag.call"]
    assert calls == ["ms.card"] * (3 if streaming else 1)


def test_timings_of_calls_on_two_threads_stay_their_own():
    ms = [_fake_ms(), _fake_ms()]
    timings, errors = [{}, {}], []

    def call(i):
        try:
            flag_measurement_set(ms[i], patch_size=16, device="cpu", streaming=bool(i),
                                 timings=timings[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and profiling._recorder is None
    assert set(timings[0]) == set(timings[1]) == STAGES
    assert span("after") is profiling._NULL


def test_without_timings_the_stages_record_only_under_a_recorder():
    ms = _fake_ms()
    flag_measurement_set(ms, patch_size=16, device="cpu")
    edges = _Edges()
    with recording(on_edge=edges):
        flag_measurement_set(ms, patch_size=16, device="cpu")
    assert [name for name, parent in edges.tree() if parent is None] == [
        "ms.load", "ms.to_card", "ms.card", "ms.to_host", "ms.save"]
