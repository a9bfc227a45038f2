"""The port's HF language-model loaders on randomly initialised HF models.

Where ``transformers`` is installed, each family's HF model is built from
its config class (random weights, no download) at 2 layers and narrow
widths: ``load_hf_model`` on the HF object (its real config class and
torch state dict) gives weights equal bit for bit to the JAX loader's on
the same object, and the loaded port model's logits match the HF model's
own forward, in fp32 on the CPU, within 1e-5 of the largest logit (the two
compute the same functions in other summation orders).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.module_inject import hf as jhf
from deepspeed_tpu_torch.module_inject import hf as thf

transformers = pytest.importorskip("transformers")

V, T = 128, 20


def _hf(family):
    torch.manual_seed(0)
    t = transformers
    if family == "gpt2":
        cfg = t.GPT2Config(vocab_size=V, n_positions=64, n_embd=64, n_layer=2, n_head=4,
                           resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        return t.GPT2LMHeadModel(cfg)
    if family == "opt":
        cfg = t.OPTConfig(vocab_size=V, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, ffn_dim=256, max_position_embeddings=64,
                          word_embed_proj_dim=64, dropout=0.0, attention_dropout=0.0)
        return t.OPTForCausalLM(cfg)
    if family == "bloom":
        # 6 heads: the ALiBi slopes past the nearest power of two
        cfg = t.BloomConfig(vocab_size=V, hidden_size=48, n_layer=2, n_head=6,
                            hidden_dropout=0.0, attention_dropout=0.0)
        return t.BloomForCausalLM(cfg)
    if family == "gpt_neox":
        cfg = t.GPTNeoXConfig(vocab_size=V, hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=256, rotary_pct=0.25,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
        return t.GPTNeoXForCausalLM(cfg)
    if family == "gpt_neo":
        cfg = t.GPTNeoConfig(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
                             attention_types=[[["global", "local"], 1]], window_size=8,
                             max_position_embeddings=64, intermediate_size=256,
                             resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)
        return t.GPTNeoForCausalLM(cfg)
    cfg = t.GPTJConfig(vocab_size=V, n_positions=64, n_embd=64, n_layer=2, n_head=4,
                       rotary_dim=8, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return t.GPTJForCausalLM(cfg)


@pytest.mark.parametrize("family", ["gpt2", "opt", "bloom", "gpt_neox", "gpt_neo", "gptj"])
def test_loaded_model_matches_the_hf_model(family):
    hf = _hf(family).eval()
    model, sd = thf.load_hf_model(hf)
    _, jparams = jhf.load_hf_model(hf)
    for name, t in sd.items():
        if name.startswith("blocks."):
            _, i, key = name.split(".")
            ref = np.asarray(jparams["blocks"][key])[int(i)]
        else:
            ref = np.asarray(jparams[name])
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
    model.load_state_dict(sd, assign=True)
    ids = torch.from_numpy(np.random.RandomState(0).randint(4, V - 4, (2, T)))
    with torch.no_grad():
        got = model.apply(ids).numpy()
        ref = hf(ids).logits.float().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
