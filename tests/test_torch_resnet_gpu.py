"""The port's ResNet on the card against the CPU (``gpu``: skips without a
card). No JAX here, so the file runs on the card with ``--noconftest``;
tests/test_torch_resnet.py holds the CPU side to flax.

The tiny ResNet (stages (1, 1), 8 filters, 100 classes, 64², batch 8)
with the same weights on both devices and every BN's scale and bias
random (so that the third BN of each block, which starts at scale 0,
reaches the logits), one training step's forward and backward, in the
f32 config (TF32 off) and the default bf16 one: the card's fused BN
pieces against the CPU's plain f32 ops, logits, running stats and every
gradient within chip_smoke.py's ``RESNET_CARD_TOL`` (from its first
seed; chip_smoke.py runs them all). The card's
convolutions run in ``channels_last``.
"""

import pytest
import torch

from chip_smoke import RESNET_CARD_SEEDS, RESNET_CARD_TOL, tiny_resnet_card_vs_cpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiny_resnet_on_the_card_matches_the_cpu(cuda, dt):
    err = tiny_resnet_card_vs_cpu(torch, dt, seed=RESNET_CARD_SEEDS[0])
    assert err["finite"] and err["channels_last"], err
    for key, tol in RESNET_CARD_TOL[dt].items():
        assert err[key] <= tol, (key, err)
