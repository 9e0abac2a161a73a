"""The port's staged recipe (`espnet_tpu_torch.bin.run`) against the JAX
package's, on the CPU: stages 1-5 of both on the same arguments give the
same data dirs and token list byte for byte; stages 8-12 of the port's
with `--device cpu` train, decode, score and pack (markers, a resumed
second call that skips every stage, RESULTS.md, a pack that unpacks);
`use_lm` and `use_ngram` add their stages' commands and the decoding
flags that JAX's recipe adds; and `prep_librispeech` gives JAX's Kaldi
dirs on a fabricated LibriSpeech layout. Mirrors tests/test_recipe.py."""

import zipfile
from pathlib import Path

import numpy as np
import pytest

from espnet_tpu.bin import prep_librispeech as jprep
from espnet_tpu.bin import run as jrun
from espnet_tpu_torch.bin import pack, prep_librispeech, run


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses this file
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    import os

    import torch as _torch

    n, env = _torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    _torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    _torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

ASR_ARGS = (
    "--run.max_epoch 2 --run.log_interval 1000 --data.batch_size 8 "
    "--model.n_mels 24 --model.use_specaug false "
    "--model.normalize global_mvn --model.encoder_type transformer "
    "--model.d_model 32 --model.num_heads 2 --model.d_ff 64 "
    "--model.num_encoder_layers 1 --model.num_decoder_layers 1 "
    "--model.decoder_d_ff 64 --model.dropout_rate 0.0 "
    "--optim.schedule constant --optim.lr 0.003")


def _args(root, extra=()):
    return [
        "--recipe.expdir", str(root / "exp"),
        "--recipe.datadir", str(root / "data"),
        "--recipe.train_set", "train",
        "--recipe.valid_set", "train",
        "--recipe.test_sets", "test",
        "--recipe.synth_utts", "12",
        "--recipe.speed_perturb", "0.9 1.0 1.1",
        "--recipe.asr_args", ASR_ARGS,
        "--recipe.decode_args", "--beam_size 2 --max_steps 24 --batch_size 4",
    ] + list(extra)


def _tree_bytes(root: Path, strip: str):
    """{relative path: bytes} under root, with `strip` (the root's own
    path, which wav.scp files name) cut out of every file."""
    out = {}
    for f in sorted(root.rglob("*")):
        if f.is_file():
            out[str(f.relative_to(root))] = f.read_bytes().replace(
                strip.encode(), b"")
    return out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_recipe")


def test_stages_1_to_5_match_jax_byte_for_byte(ws):
    jrun.main(_args(ws / "jax", ["--recipe.stop_stage", "5"]))
    run.main(_args(ws / "torch", ["--recipe.stop_stage", "5",
                                  "--device", "cpu"]))
    jdata = _tree_bytes(ws / "jax" / "data", str(ws / "jax"))
    tdata = _tree_bytes(ws / "torch" / "data", str(ws / "torch"))
    assert "train_sp_filtered/wav.scp" in tdata
    assert any(k.startswith("train_sp/wav/sp0.9-") for k in tdata)
    assert tdata == jdata
    for name in ("tokens/tokens.txt",):
        assert ((ws / "torch" / "exp" / name).read_bytes()
                == (ws / "jax" / "exp" / name).read_bytes())
    for n in range(1, 6):
        assert (ws / "torch" / "exp" / f".stage{n}.done").exists()
    assert not (ws / "torch" / "exp" / ".stage6.done").exists()


def test_stages_8_to_12_train_decode_score_and_pack(ws, caplog):
    root = ws / "torch"
    exp = root / "exp"
    run.main(_args(root, ["--device", "cpu"]))
    for n in range(1, 13):
        assert (exp / f".stage{n}.done").exists(), n
    for name in ("asr/checkpoint.pt", "asr/ep2.params.msgpack",
                 "asr/stats/feats_stats.npz", "decode_test/text",
                 "decode_test/score_wer.txt", "results.json"):
        assert (exp / name).exists(), name
    assert "device" not in (exp / "asr" / "config.yaml").read_text().replace(
        "device parallelism", "")
    results = (exp / "RESULTS.md").read_text()
    assert "## test" in results and "# Snt" in results
    # a second call skips every stage
    stamp = (exp / "asr" / "ep2.params.msgpack").stat().st_mtime_ns
    caplog.clear()
    with caplog.at_level("INFO", logger="espnet_tpu"):
        run.main(_args(root, ["--device", "cpu"]))
    skipped = [r.getMessage() for r in caplog.records
               if "already done, skipping" in r.getMessage()]
    assert len(skipped) == 12
    assert (exp / "asr" / "ep2.params.msgpack").stat().st_mtime_ns == stamp
    # the pack unpacks to the experiment's files (the token list stays in
    # exp/tokens, which config.yaml names, as in the JAX recipe)
    out = pack.main(["--unpack", str(exp / "packed_model.zip"),
                     "--output_dir", str(root / "unpacked")])
    with zipfile.ZipFile(exp / "packed_model.zip") as z:
        names = set(z.namelist())
    assert {"config.yaml", "stats/feats_stats.npz", "ep2.params.msgpack",
            "valid.acc.ave.params.msgpack"} <= names
    for name in names:
        assert ((out / name).read_bytes()
                == (exp / "asr" / name).read_bytes()), name


@pytest.mark.parametrize("token_type", ["char", "bpe"])
def test_use_ngram_runs_stage7_and_passes_the_file_to_decoding(
        tmp_path, monkeypatch, token_type):
    """Stage 7 runs `ngram_train` on the training text with the recipe's
    token type (and its BPE model), and decoding gets `--ngram_file` but no
    weight, as in the JAX recipe (the commands are recorded here, not run;
    tests/test_torch_ngram.py runs stage 7)."""
    from espnet_tpu_torch import recipe

    calls = []
    monkeypatch.setattr(recipe, "_run_cli",
                        lambda module, args: calls.append((module, args)))
    r = recipe.Recipe(recipe.RecipeConfig(
        expdir=str(tmp_path / "exp"), datadir=str(tmp_path / "data"),
        use_ngram=True, ngram_order=4, token_type=token_type,
        decode_args="--beam_size 2"), device="cpu")
    r.stage7_ngram()
    r.stage10_decode()
    (ng_mod, ng_args), (dec_mod, dec_args) = calls
    arpa = str(tmp_path / "exp" / "ngram" / "4gram.arpa")
    assert ng_mod == "espnet_tpu_torch.bin.ngram_train"
    assert ng_args[ng_args.index("--output") + 1] == arpa
    assert ng_args[ng_args.index("--order") + 1] == "4"
    assert ng_args[ng_args.index("--token_type") + 1] == token_type
    assert ng_args[ng_args.index("--data_dir") + 1] == str(
        tmp_path / "data" / "train")
    assert ("--bpe_model" in ng_args) == (token_type == "bpe")
    assert "--device" not in ng_args
    assert dec_mod == "espnet_tpu_torch.bin.asr_inference"
    assert dec_args[dec_args.index("--ngram_file") + 1] == arpa
    assert "--ngram_weight" not in dec_args


def test_use_lm_runs_stage6_and_passes_the_lm_to_decoding(tmp_path,
                                                          monkeypatch):
    """Stage 6 runs `lm_train` and decoding gets `--lm_exp_dir`, as in the
    JAX recipe (the commands are recorded here, not run)."""
    from espnet_tpu_torch import recipe

    calls = []
    monkeypatch.setattr(recipe, "_run_cli",
                        lambda module, args: calls.append((module, args)))
    r = recipe.Recipe(recipe.RecipeConfig(
        expdir=str(tmp_path / "exp"), datadir=str(tmp_path / "data"),
        use_lm=True, lm_args="--model.num_layers 2",
        decode_args="--lm_weight 0.3"), device="cpu")
    r.stage6_lm()
    r.stage10_decode()
    (lm_mod, lm_args), (dec_mod, dec_args) = calls
    assert lm_mod == "espnet_tpu_torch.bin.lm_train"
    assert lm_args[lm_args.index("--run.output_dir") + 1] == str(
        tmp_path / "exp" / "lm")
    assert lm_args[lm_args.index("--data.token_list") + 1] == str(
        tmp_path / "exp" / "tokens" / "tokens.txt")
    assert "--model.num_layers" in lm_args and lm_args[-2:] == ["--device",
                                                               "cpu"]
    assert dec_mod == "espnet_tpu_torch.bin.asr_inference"
    assert dec_args[dec_args.index("--lm_exp_dir") + 1] == str(
        tmp_path / "exp" / "lm")
    assert "--lm_weight" in dec_args


@pytest.fixture(scope="module")
def mini_librispeech(tmp_path_factory):
    """The LibriSpeech layout (reader/chapter tree, transcripts,
    SPEAKERS.TXT, FLAC audio by the port's encoder) in miniature."""
    from espnet_tpu_torch.data.flac import write_flac

    root = tmp_path_factory.mktemp("LibriSpeech")
    rng = np.random.RandomState(0)
    texts = {
        "train-clean-100": {("19", "198"): ["HELLO WORLD", "A SECOND ONE"],
                            ("26", "495"): ["SPEECH RECOGNITION WORKS"]},
        "dev-clean": {("84", "121123"): ["DEV SET UTTERANCE"]},
        "dev-other": {("116", "288045"): ["OTHER DEV UTTERANCE"]},
        "test-clean": {("1089", "134686"): ["TEST SET UTTERANCE"]},
    }
    for part, chapters in texts.items():
        for (reader, chapter), utts in chapters.items():
            d = root / part / reader / chapter
            d.mkdir(parents=True)
            lines = []
            for i, words in enumerate(utts):
                utt = f"{reader}-{chapter}-{i:04d}"
                wav = (0.1 * rng.randn(4000)).astype(np.float32)
                write_flac(d / f"{utt}.flac", wav, 16000, mode="fixed")
                lines.append(f"{utt} {words}")
            (d / f"{reader}-{chapter}.trans.txt").write_text(
                "\n".join(lines) + "\n")
    (root / "SPEAKERS.TXT").write_text(
        ";ID |SEX| SUBSET           |MINUTES| NAME\n"
        "19  | F | train-clean-100  | 25.03 | Kara\n"
        "26  | M | train-clean-100  | 25.08 | Sean\n"
        "84  | F | dev-clean        | 8.02  | Chris\n"
        "116 | M | dev-other        | 8.02  | Pat\n")
    return root


def test_prep_librispeech_matches_jax(mini_librispeech, tmp_path):
    args = ["--librispeech", str(mini_librispeech), "--parts",
            "train-clean-100", "dev-clean", "dev-other", "test-clean"]
    jprep.main(args + ["--output_dir", str(tmp_path / "jax")])
    prep_librispeech.main(args + ["--output_dir", str(tmp_path / "torch")])
    want = _tree_bytes(tmp_path / "jax", "")
    assert {"dev/wav.scp", "train_clean_100/spk2gender",
            "test_clean/text"} <= set(want)
    assert _tree_bytes(tmp_path / "torch", "") == want
    # the port reads the FLAC files it names
    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav

    wav, sr = read_wav(next(iter(read_2column_text(
        tmp_path / "torch" / "train_clean_100" / "wav.scp").values())))
    assert sr == 16000 and wav.shape == (4000,)


def test_bpe_token_list_matches_jax_and_needs_tokenizers(tmp_path,
                                                         monkeypatch):
    from espnet_tpu.bin import build_token_list as jbuild
    from espnet_tpu_torch.bin import build_token_list

    text = tmp_path / "text"
    text.write_text("".join(f"u{i} THE QUICK BROWN FOX NUMBER {i}\n"
                            for i in range(20)))
    args = ["--text", str(text), "--token_type", "bpe",
            "--bpe_vocab_size", "40"]
    jbuild.main(args + ["--output_dir", str(tmp_path / "jax")])
    build_token_list.main(args + ["--output_dir", str(tmp_path / "torch")])
    for name in ("tokens.txt", "bpe.json"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    monkeypatch.setitem(__import__("sys").modules, "tokenizers", None)
    with pytest.raises(ImportError, match="needs the HF `tokenizers`"):
        build_token_list.main(args + ["--output_dir", str(tmp_path / "t2")])
