"""The port's encoder calibration (`hcrag_tpu_torch/tools/encoder_confidence.py`)
and HF weight converter (`hcrag_tpu_torch/tools/convert_minilm.py`) against
the JAX tools (`tools/encoder_confidence.py`, `tools/convert_minilm.py`), on
the CPU.

  * The calibration: the JAX distillation's held-out mode (40 seeded corpus
    texts with the committed encoder's vectors, batch 4, max_len 16, 4
    steps) writes one held-out encoder; both packages' `encoder_confidence`
    calibrate it.  The JAX tool runs unmodified with its `PICKLE`, `BASE`,
    `CALIB_PATH` and `REPORT_PATH` in a temporary directory.  The
    calibration, the AUCs and every number of the report agree within 1e-6
    (NaN equal to NaN: an AUC without one of the label classes), and each
    package's `load_calibration` reads either file.
  * The converter: a synthetic HF-named state dict (d 48, 12 heads, 2
    layers, seeded) converts array for array as JAX's does, from memory,
    from `pytorch_model.bin` and from `model.safetensors`; the port's
    encoder on the result equals the Flax encoder within 1e-6.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import tools.convert_minilm as jconvert
import tools.distill_minilm as jdistill
import tools.encoder_confidence as jconf_tool
from hcrag_tpu.models import confidence as jconf
from hcrag_tpu.models import minilm as jminilm
from hcrag_tpu_torch.models import confidence as tconf
from hcrag_tpu_torch.models import minilm as tminilm
from hcrag_tpu_torch.tools import convert_minilm as tconvert
from hcrag_tpu_torch.tools import encoder_confidence as tconf_tool
from tests.test_torch_distill import golden_set

TOL = 1e-6


@pytest.fixture(scope="module")
def calibrations(tmp_path_factory):
    """Both packages' calibration of one JAX held-out encoder."""
    tmp = str(tmp_path_factory.mktemp("confidence"))
    pk = golden_set(tmp, 40)
    base = f"{tmp}/tools/minilm_distilled"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdistill, "PICKLE", pk)
        mp.setattr(jdistill, "REPO", tmp)
        jdistill.main(["--steps", "4", "--scan-chunk", "2", "--batch", "4", "--max-len", "16",
                       "--holdout-frac", "0.2", "--augment", "1", "--out", base])
        mp.setattr(jconf_tool, "PICKLE", pk)
        mp.setattr(jconf_tool, "BASE", base)
        mp.setattr(jconf_tool, "CALIB_PATH", f"{tmp}/jax_calibration.json")
        mp.setattr(jconf_tool, "REPORT_PATH", f"{tmp}/jax_report.json")
        jconf_tool.main()
    report = tconf_tool.main(["--base", base, "--pickle", pk, "--out", f"{tmp}/port",
                              "--device", "cpu"])
    return {"tmp": tmp, "pickle": pk, "base": base, "report": report}


def _close(a, b, path=""):
    """Equal keys, numbers within TOL (NaN equal to NaN), strings equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, path


@pytest.mark.parametrize("kind", ["calibration", "report"])
def test_calibration_matches_jax(calibrations, kind):
    tmp = calibrations["tmp"]
    port = json.load(open(f"{tmp}/port_{kind}.json"))
    _close(port, json.load(open(f"{tmp}/jax_{kind}.json")))
    if kind == "report":
        assert port == json.loads(json.dumps(calibrations["report"]))
        assert port["n_eval_queries"] == 4 * port["n_holdout"] == 32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_loads_in_both_packages(calibrations, writer):
    path = f"{calibrations['tmp']}/{writer}_calibration.json"
    a, b = tconf.load_calibration(path), jconf.load_calibration(path)
    assert a == b and {"bias", "w_max_sim", "w_agreement", "auc"} <= set(a)
    feats = {"max_sim": np.array([0.2, 0.9]), "ensemble_agreement": np.array([0.1, 1.0])}
    np.testing.assert_allclose(tconf.confidence_scores(feats, a),
                               jconf.confidence_scores(feats, b), rtol=0, atol=0)


def test_missing_holdout_encoder_exits(calibrations, tmp_path):
    with pytest.raises(SystemExit, match="holdout"):
        tconf_tool.main(["--base", str(tmp_path / "none"), "--pickle", calibrations["pickle"],
                         "--out", str(tmp_path / "c"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "c_calibration.json")


def test_calibration_defaults_to_cuda(calibrations, tmp_path):
    argv = ["--base", calibrations["base"], "--pickle", calibrations["pickle"],
            "--out", str(tmp_path / "c")]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tconf_tool.main(argv)


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------
D, HEADS, LAYERS, FFN, VOCAB, POS = 48, 12, 2, 96, 60, 24


def hf_state(seed=0, prefix="bert."):
    """A seeded state dict under HF BertModel's names."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    sd = {
        "embeddings.word_embeddings.weight": t(VOCAB, D),
        "embeddings.position_embeddings.weight": t(POS, D),
        "embeddings.token_type_embeddings.weight": t(2, D),
        "embeddings.LayerNorm.weight": 1 + t(D), "embeddings.LayerNorm.bias": t(D),
        "pooler.dense.weight": t(D, D),  # not an encoder weight: dropped
    }
    for i in range(LAYERS):
        hf = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd[f"{hf}.attention.self.{name}.weight"] = t(D, D)
            sd[f"{hf}.attention.self.{name}.bias"] = t(D)
        sd[f"{hf}.attention.output.dense.weight"] = t(D, D)
        sd[f"{hf}.attention.output.dense.bias"] = t(D)
        sd[f"{hf}.attention.output.LayerNorm.weight"] = 1 + t(D)
        sd[f"{hf}.attention.output.LayerNorm.bias"] = t(D)
        sd[f"{hf}.intermediate.dense.weight"] = t(FFN, D)
        sd[f"{hf}.intermediate.dense.bias"] = t(FFN)
        sd[f"{hf}.output.dense.weight"] = t(D, FFN)
        sd[f"{hf}.output.dense.bias"] = t(D)
        sd[f"{hf}.output.LayerNorm.weight"] = 1 + t(D)
        sd[f"{hf}.output.LayerNorm.bias"] = t(D)
    return {prefix + k: v for k, v in sd.items()}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_convert_equals_jax(prefix):
    sd = hf_state(prefix=prefix)
    _equal(tconvert.convert(sd, LAYERS, HEADS), jconvert.convert(sd, LAYERS, HEADS))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_hf_state_dict_equals_jax(tmp_path, fmt):
    sd = hf_state(seed=1)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file(sd, str(tmp_path / "model.safetensors"))
    got = tconvert.load_hf_state_dict(str(tmp_path))
    _equal(got, jconvert.load_hf_state_dict(str(tmp_path)))
    _equal(got, sd)


def test_load_hf_state_dict_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tconvert.load_hf_state_dict(str(tmp_path))


def test_converted_encoder_equals_flax(tmp_path):
    """The converter's main on a checkpoint directory: the file equals the
    JAX conversion, and the port's encoder over it equals Flax's (1e-6)."""
    sd = hf_state(seed=2)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    out = str(tmp_path / "converted.npz")
    tconvert.main([str(tmp_path), out, "--device", "cpu"])
    with np.load(out) as z:
        _equal({k: z[k] for k in z.files}, jconvert.convert(sd, LAYERS, HEADS))
    cfg = dict(vocab_size=VOCAB, hidden_size=D, num_layers=LAYERS, num_heads=HEADS,
               intermediate_size=FFN, max_position=POS)
    assert tconvert.num_layers_of(sd) == LAYERS
    assert tconvert.config_of(tconvert.convert(sd, LAYERS, HEADS)) == \
        tminilm.MiniLMConfig(**cfg)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, VOCAB, size=(6, POS)).astype(np.int32)
    mask = (np.arange(POS)[None, :] < rng.integers(1, POS + 1, size=(6, 1))).astype(np.int32)
    t = tminilm.MiniLMEmbedder(tminilm.MiniLMConfig(**cfg), device="cpu")
    t.load_params(out)
    j = jminilm.FlaxMiniLMEmbedder(jminilm.MiniLMConfig(**cfg))
    j.load_params(out)
    with torch.no_grad():
        got = t.model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert np.abs(got - np.asarray(j._apply(j.params, ids, mask))).max() <= 1e-6


def test_converter_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        return
    torch.save({k: torch.from_numpy(v) for k, v in hf_state().items()},
               tmp_path / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="CUDA"):
        tconvert.main([str(tmp_path), str(tmp_path / "o.npz")])
