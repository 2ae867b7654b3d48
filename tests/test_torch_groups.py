"""The attention kernels take every head group from 1 to 8.

The port's CUDA attention wrappers once accepted only H / n_kv in
{1, 2, 4, 8}, so every Qwen2 model (28 q / 4 kv heads: G 7; Qwen2-VL-2B's
12 / 2: G 6) raised at its first prefill on the card while the CPU tests,
which run the plain versions, never saw it.  The shape check of the
wrappers (`cuda_attention.check_heads`) runs without a card: every canned
config must pass it, and so must G 6 at head dim 128.  The kernels' own
results at G 7 and G 6 are held to their plain versions on the card
(`chip_smoke.py` phase 3).
"""

import pytest

from dynamo_tpu_torch.models.config import CONFIGS
from dynamo_tpu_torch.ops import cuda_attention as ca


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_canned_config_heads_accepted(name):
    cfg = CONFIGS[name]
    ca.check_heads(cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_)


@pytest.mark.parametrize("H,n_kv,hd", [(12, 2, 128), (28, 4, 128), (14, 2, 64),
                                       (24, 8, 64), (40, 8, 128)])
def test_every_group_up_to_8_accepted(H, n_kv, hd):
    ca.check_heads(H, n_kv, hd)


@pytest.mark.parametrize("H,n_kv,hd,what", [
    (36, 4, 128, "not in"),  # G 9
    (30, 4, 128, "not in"),  # not a whole group
    (28, 4, 96, "head_dim"),
])
def test_refused_shapes(H, n_kv, hd, what):
    with pytest.raises(ValueError, match=what):
        ca.check_heads(H, n_kv, hd)
