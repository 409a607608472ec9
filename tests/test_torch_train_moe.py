"""The port's training loss and gradients against the reference's for
the MoE and hybrid families (qwen3-moe: the aux loss in the loss;
mixtral: experts and a 64-token window at reduced size; jamba: the
hybrid period, MoE at odd positions), at ``.reduced()`` size. The
reference runs op by op with its routing recorded and replayed in the
port (compiled, XLA keeps the bf16 router product in fp32 and can route
a near-tie differently, ROADMAP §3), so both sides differentiate one
routing. Bounds and their reasons: ``test_torch_train_parity.py``."""
import pytest
import torch

from test_torch_train_parity import hold_loss_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_moe_loss_and_grads_match_the_reference(name, monkeypatch,
                                                record_property):
    hold_loss_and_grads(name, monkeypatch, record_property, op_by_op=True)
