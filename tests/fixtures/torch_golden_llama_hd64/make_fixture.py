"""Generate the head-dim-64 golden Llama fixture from transformers (CPU).

    python tests/fixtures/torch_golden_llama_hd64/make_fixture.py

The fixture of `scripts/make_golden_fixtures.py` (golden_llama) has head
dim 16, which neither CUDA attention kernel of the port takes; this one
has head dim 64, 2 query heads over 1 kv head and 2 layers in f32, so
the same checkpoint anchors the port's forward on the CPU and, through
both kernels, on the GPU.  Its vocabulary is the tiny test tokenizer's
(261 ids, `dynamo_tpu.testing.tiny_tokenizer`), saved beside the weights
as tokenizer.json.  golden_logits.npz holds, per prompt, the prefill
logits and the logits of each greedy decode step ([T+1, V]) and the
greedy continuation, as `make_golden_fixtures.py` stores them.
Generated with transformers 4.57.6.
"""

import os

import numpy as np
import torch

OUT = os.path.dirname(os.path.abspath(__file__))
DECODE_STEPS = 5
TEXTS = ["the quick brown fox jumps over the lazy dog",
         "paged attention with 64-wide heads: 0123456789"]


def main() -> None:
    from transformers import LlamaConfig, LlamaForCausalLM

    from dynamo_tpu.testing import tiny_tokenizer

    tok = tiny_tokenizer()
    torch.manual_seed(0x64)
    cfg = LlamaConfig(
        vocab_size=tok.vocab_size,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=2,
        num_key_value_heads=1,
        head_dim=64,
        max_position_embeddings=512,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        attention_bias=False,
    )
    model = LlamaForCausalLM(cfg).eval().float()
    model.save_pretrained(OUT, safe_serialization=True)
    with open(os.path.join(OUT, "tokenizer.json"), "w", encoding="utf-8") as f:
        f.write(tok.to_json_str())

    arrays = {}
    with torch.no_grad():
        for i, text in enumerate(TEXTS):
            prompt = tok.encode(text)
            toks = list(prompt)
            steps = []
            for _ in range(DECODE_STEPS + 1):
                lg = model(torch.tensor([toks])).logits[0, -1].numpy()
                steps.append(lg.astype(np.float32))
                toks.append(int(lg.argmax()))
            arrays[f"prompt{i}"] = np.asarray(prompt, np.int32)
            arrays[f"logits{i}"] = np.stack(steps)  # [T+1, V]
            arrays[f"greedy{i}"] = np.asarray(toks[len(prompt):], np.int32)
    np.savez(os.path.join(OUT, "golden_logits.npz"), **arrays)
    print("torch_golden_llama_hd64:", OUT)


if __name__ == "__main__":
    main()
