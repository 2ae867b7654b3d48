"""The one registry of kernel launches.

Each kernel wrapper adds one to its kernel's entry where it launches it,
and nowhere else; the engine's graph runner adds the launches a capture
recorded at every replay.  `chip_smoke.py` zeroes the registry before it
drives a path and reads it after.  "decode_attention" counts calls of the
public function (each a split pass, then a merge pass), "decode_merge"
the merge launches.  "moe_grouped_gemm" counts calls of the grouped GEMM
(with K in slices, a slice pass then a sum pass), "moe_split_reduce" the
sum passes, "moe_grouped_glu" the fused gate||up launches, "kv_repage"
the KV re-page launches of disaggregated serving (one a transfer, K and V
together), "segment_attention" the vision towers' segment attention.
"""

LAUNCHES = {"decode_attention": 0, "decode_merge": 0, "prefill_attention": 0,
            "moe_grouped_gemm": 0, "moe_split_reduce": 0, "moe_grouped_glu": 0,
            "kv_repage": 0, "segment_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
