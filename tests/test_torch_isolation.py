"""The PyTorch port stands alone: no JAX, no espnet_tpu, no triton at import.

The card's machine has torch but no jax/flax/optax/yaml/msgpack/
transformers/safetensors, so any such import in espnet_tpu_torch/ or
chip_smoke.py would kill the run there. Entry points
run on the CUDA card unless the caller passes device="cpu", and raise
rather than fall back when there is no card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "espnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "espnet_tpu", "triton", "yaml",
             "msgpack", "transformers", "safetensors")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_level_imports(tree):
    """Imports outside any function body."""
    found = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                found.extend(a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                found.append(child.module)
            visit(child)

    visit(tree)
    return found


def _all_imports(tree):
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_module_level_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _module_level_imports(tree) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad} at module level"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_anywhere(path):
    """Not even inside a function: the port keeps its own copies (and its
    own YAML and msgpack codecs)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _all_imports(tree)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "espnet_tpu", "yaml", "msgpack",
                                  "transformers", "safetensors")]
    assert not bad, f"{path}: imports {bad}"


def test_port_files_found():
    names = {p.name for p in _port_files()}
    assert {"asr_inference.py", "relpos_attention.py", "prenorm_ffn.py",
            "chip_smoke.py", "convert.py", "ctc_lattice.py", "ctc.py",
            "dropout.py", "specaug.py", "losses.py", "schedulers.py",
            "optim.py", "steps.py", "ffn.py", "flash_attention.py",
            "branchformer.py", "normalize.py", "ffn_common.py",
            "configs.py", "conv_glu.py", "conv_module.py", "asr_train.py",
            "trainer.py", "checkpoint.py", "msgpack_io.py", "config.py",
            "dataset.py", "collect_stats.py", "pretrained.py", "recipe.py",
            "run.py", "make_synth_data.py", "build_token_list.py",
            "pack.py", "prep_librispeech.py", "ctc_greedy.py", "remat.py",
            "launches.py", "ssl.py", "hubert.py", "kmeans.py",
            "hf_import.py", "convert_hf.py", "hubert_train.py",
            "fastspeech2.py", "tacotron2.py", "transformer_tts.py",
            "prodiff.py", "gst.py", "spk_embed.py", "vc.py", "model.py",
            "griffin_lim.py", "pitch.py", "stft.py", "tts_metrics.py",
            "tts.py", "recipe_tts.py", "tts_train.py", "tts_inference.py",
            "tts_teacher_durations.py", "tts_scoring.py", "vc_train.py",
            "spk_embed_extract.py", "run_tts.py", "pqmf.py", "hifigan.py",
            "vocoders.py", "wavenet.py", "vits.py", "jets.py",
            "gan_steps.py", "vocoder.py", "vocoder_train.py",
            "vits_train.py", "vits_inference.py", "jets_train.py",
            "jets_inference.py", "enh_losses.py", "separators.py",
            "dc_crn.py", "dccrn.py", "dpcl_e2e.py", "svoice.py",
            "fasnet.py", "ineube.py", "se_metrics.py", "pesq_py.py",
            "enh.py", "recipe_enh.py", "enh_train.py", "enh_inference.py",
            "enh_scoring.py", "run_enh.py"} <= names


_NO_CARD_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.modules["yaml"] = None
sys.modules["msgpack"] = None
import torch
torch.cuda.is_available = lambda: False
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
model = ASRModel(ASRConfig(vocab_size=8, d_model=32, num_heads=2, d_ff=128,
                           num_encoder_layers=1, num_decoder_layers=1,
                           decoder_d_ff=64, conformer_kernel_size=3,
                           normalize="utterance_mvn"))
for device in (None, "cuda"):
    try:
        Speech2Text(model, device=device)
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit(f"device={device!r} did not raise without a card")
s2t = Speech2Text(model, device="cpu")
assert s2t.device.type == "cpu"
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.steps import make_eval_step, make_train_step
tx = build_optimizer("fused_adam")
for make in (lambda d: make_train_step(model, tx, device=d),
             lambda d: make_eval_step(model, device=d)):
    for device in (None, "cuda"):
        try:
            make(device)
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise SystemExit(f"device={device!r} did not raise without a card")
    make("cpu")
from espnet_tpu_torch.bin import (asr_inference, asr_train, enh_inference,
                                  enh_train, jets_inference, jets_train, run,
                                  run_enh, vits_inference, vits_train,
                                  vocoder_train)
decode = ["--exp_dir", "unused", "--data_dir", "unused", "--output_dir",
          "unused"]
clis = (lambda extra: asr_train.main(["--run.output_dir", "unused"] + extra),
        lambda extra: asr_inference.main(decode + extra),
        lambda extra: run.main(["--recipe.expdir", "unused",
                                "--recipe.datadir", "unused"] + extra),
        lambda extra: vocoder_train.main(["--run.output_dir", "unused"]
                                         + extra),
        lambda extra: vits_train.main(["--run.output_dir", "unused"] + extra),
        lambda extra: jets_train.main(["--run.output_dir", "unused"] + extra),
        lambda extra: vits_inference.main(decode + extra),
        lambda extra: jets_inference.main(decode + extra),
        lambda extra: enh_train.main(["--run.output_dir", "unused"] + extra),
        lambda extra: enh_inference.main(decode + extra),
        lambda extra: run_enh.main(["--recipe.expdir", "unused",
                                    "--recipe.datadir", "unused"] + extra))
for cli in clis:
    for extra in ([], ["--device", "cuda"]):
        try:
            cli(extra)
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise SystemExit(f"{extra} did not raise without a card")
print("OK")
"""


def test_entry_point_raises_without_card_and_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_CARD_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_fails_without_card(tmp_path):
    """No card (and no repository around it): exit code other than 0 and
    no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
