"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell can have), and when the control (the reference in a
lower precision) stands in the program's place."""
import pytest

from mstbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,fault,check", [
    ("tiny_songs", "altered_mixture", "mix_err"),
    ("tiny_train", "frozen_state", "change_gap"),
    ("tiny_train", "half_batch", "loss_gap"),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, check):
    res = tiny.drive(root, cell, fault=fault)
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]


def test_the_fp8_control_is_not_correct(root):
    res = tiny.drive(root, "tiny_songs", control="control")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card(root, cuda_device):
    """TF32 exists only on the card."""
    import torch

    res = tiny.drive(root, "tiny_train", control="control", device="cuda")
    assert torch.cuda.is_available() and not res["correct"], res["checks"]
