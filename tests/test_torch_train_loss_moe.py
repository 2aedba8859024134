"""``repro_torch.models.lm.train_loss`` and its gradients against the
reference's (``test_torch_train_loss.py`` holds the method and the other
families) on the smoke configs of the MoE (``olmoe-1b-7b``), MLA + MoE
(``deepseek-v2-lite-16b``) and hybrid (``zamba2-1.2b``) families, with the
router's load-balancing loss in the objective.

Bars: 1e-5 (loss, parts, each gradient leaf against its max |g|); 1e-4 on
zamba2, the bar downstream of the SSD (ROADMAP.md, Queue 1 item 9).
"""

import pytest

pytest.importorskip("torch")

from test_torch_train_loss import check_train_loss  # noqa: E402


@pytest.mark.parametrize("arch,tol", [("olmoe-1b-7b", 1e-5), ("deepseek-v2-lite-16b", 1e-5),
                                      ("zamba2-1.2b", 1e-4)])
def test_train_loss_and_grads_match_reference(arch, tol):
    gaps = check_train_loss(arch, tol)
    if arch != "zamba2-1.2b":
        assert any("router" in name for name in gaps)   # the router is trained
