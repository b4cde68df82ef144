"""``train_steps``' CUDA graph of a step's forward and backward
(``train.trainer.StepGraph``) against the eager steps of ``train_step``.

On the CPU the steps stay eager. The tests that need a CUDA card decide
inside the ``card`` fixture and skip without one; on a card run them with
``RFI_TEST_TPU=1 python -m pytest tests/test_torch_step_graph.py`` (the
variable keeps ``conftest.py`` from importing JAX, which the card's
machine need not have).
"""

import copy

import pytest
import torch

from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.train import create_train_state, train_step, train_steps
from rfi_toolbox_tpu_torch.utils.profiling import recording


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the step graph runs on one alone")
    return torch.device("cuda")


def _states(device, dtype=torch.bfloat16):
    """Two train states from the same weights."""
    with torch.device(device):
        model = UNet(init_features=8, depth=2, norm="batch", dtype=dtype)
    state = create_train_state(model, seed=3, device=device)
    return state, copy.deepcopy(state)


def _feed(device, steps=4, batch=4, size=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(steps, batch, size, size, 3, generator=g)
    labels = (torch.rand(steps, batch, size, size, generator=g) > 0.7).to(torch.uint8)
    return images.to(device), labels.to(device)


def _eager(state, images, labels):
    return torch.stack([train_step(state, images[s], labels[s])[1]
                        for s in range(images.shape[0])])


def _tensors(state):
    return ([p.detach() for p in state.params] + state.mu + state.nu
            + list(state.model.buffers()))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_the_steps_stay_eager_off_the_card():
    state, twin = _states("cpu", torch.float32)
    images, labels = _feed("cpu", steps=2, batch=2, size=16)
    assert torch.equal(train_steps(state, images, labels)[1], _eager(twin, images, labels))
    assert state.step_graph is None and _same(state, twin)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graph_steps_are_the_eager_steps(card, dtype):
    """Two calls of four steps: the first step eager, the second captured,
    the rest replayed; losses, parameters, Adam's moments and the
    BatchNorm statistics bit for bit those of the eager steps."""
    graphed, eager = _states(card, dtype)
    for seed in range(2):
        f = _feed(card, seed=seed)
        assert torch.equal(train_steps(graphed, *f)[1], _eager(eager, *f))
    assert graphed.step_graph.graph is not None
    assert _same(graphed, eager)


def test_a_new_shape_or_model_tensor_makes_a_new_graph(card):
    graphed, eager = _states(card)
    for batch in (4, 2, 4):
        f = _feed(card, steps=3, batch=batch, seed=batch)
        first = graphed.step_graph
        assert torch.equal(train_steps(graphed, *f)[1], _eager(eager, *f))
        assert graphed.step_graph is not first
    for s in (graphed, eager):  # the same values at a new address
        s.model.head.weight = torch.nn.Parameter(s.model.head.weight.detach().clone())
        s.params = list(s.model.parameters())
    f = _feed(card, steps=3, seed=9)
    first = graphed.step_graph
    assert torch.equal(train_steps(graphed, *f)[1], _eager(eager, *f))
    assert graphed.step_graph is not first and _same(graphed, eager)


def test_the_spans_of_the_graph_steps(card):
    state, _ = _states(card)
    with recording() as rec:
        train_steps(state, *_feed(card))
    names = [s.name for s in rec.spans]
    # the eager warm-up step, then three steps that replay the graph
    assert names.count("train.step") == 4
    assert names.count("train.forward") == names.count("train.backward") == 1
    assert names.count("train.replay") == 3 and names.count("train.optimizer") == 4
