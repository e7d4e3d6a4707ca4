"""``serve --mode lm`` of the port on the CPU, one arch of each family:
the reference's seven keys, greedy tokens in the vocabulary, the first of
them the prefill's argmax; the step builders; no card and no
``--device cpu`` raises.
"""
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step

from _torch_lm_common import one_torch_thread  # noqa: F401

KEYS = {"arch", "batch", "prompt_len", "prefill_s", "decode_tokens",
        "decode_tok_per_s", "sample_tokens"}
ONE_PER_FAMILY = ["qwen2-1.5b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
                  "recurrentgemma-9b", "whisper-large-v3", "paligemma-3b"]


@pytest.mark.parametrize("arch", ONE_PER_FAMILY)
def test_serve_lm_on_cpu(arch, capsys):
    argv = ["--mode", "lm", "--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--decode-tokens", "5"]
    out = serve.main(argv)
    assert set(out) == KEYS
    assert (out["arch"], out["batch"], out["prompt_len"],
            out["decode_tokens"]) == (arch, 2, 12, 5)
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0
    V = smoke_config(arch).vocab_size
    assert len(out["sample_tokens"]) == 6
    assert all(0 <= t < V for t in out["sample_tokens"])
    assert '"decode_tok_per_s"' in capsys.readouterr().out

    lm = serve.lm_session(serve.build_parser().parse_args(argv))
    assert lm["capacity"] == 12 + 5 + 1 + lm["model"].prefix_len()
    _, logits = make_prefill_step(lm["model"])(lm["params"], lm["batch"],
                                               lm["capacity"])
    assert out["sample_tokens"][0] == int(serve.next_token(logits)[0, 0])


def test_decode_step_is_the_model_decode():
    argv = ["--mode", "lm", "--device", "cpu", "--batch", "1",
            "--prompt-len", "6", "--decode-tokens", "1"]
    lm = serve.lm_session(serve.build_parser().parse_args(argv))
    model, params = lm["model"], lm["params"]
    cache, logits = model.prefill(params, lm["batch"], lm["capacity"])
    tok = serve.next_token(logits)
    c2 = {k: v.clone() for k, v in cache.items()}
    _, want = model.decode(params, cache, tok, 6)
    _, got = make_decode_step(model)(params, c2, tok, 6)
    assert torch.equal(want, got)


def test_serve_lm_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "lm", "--arch", "qwen2-1.5b"])
