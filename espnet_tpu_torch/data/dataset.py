# Port of espnet_tpu/data/dataset.py: where the JAX module asks
# jax.process_count() and jax.process_index(), this one asks torch.distributed
# (world size and rank when it is initialised, 1 and 0 when it is not).
"""Dataset + collate: data dir -> statically-shaped numpy batches.

Behavioral spec: reference `espnet2/train/dataset.py:368` (ESPnetDataset:
name -> (path, loader type)), `espnet2/train/collate_fn.py:11`
(CommonCollateFn: pad to batch max, emit <name>_lengths) and
`espnet2/train/preprocessor.py:126` (CommonPreprocessor: tokenize text on
the fly). TPU difference: the collate pads to the *bucket-quantized* shape
carried by the sampler `Batch`, so jit sees a bounded shape set.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from espnet_tpu_torch.data.fileio import SoundScpReader, NpyScpReader, read_2column_text
from espnet_tpu_torch.data.sampler import Batch, build_batches, shard_batches, shuffle_batches


class ASRDataset:
    """Speech (wav.scp or feats.scp) + text, tokenized on access."""

    def __init__(
        self,
        wav_scp: Optional[str] = None,
        feats_scp: Optional[str] = None,
        text: Optional[str] = None,
        tokenizer=None,
        converter=None,
        fs: int = 16000,
        src_text: Optional[str] = None,
        src_tokenizer=None,
        src_converter=None,
        multichannel: bool = False,
        preprocessor=None,
        transform=None,
        transform_train: bool = True,
    ):
        # multichannel=True keeps (N, C) wavs intact (WPE/beamformer
        # front-end inside the ASR model); default selects channel 0.
        # preprocessor: optional callable wav -> wav applied to raw speech
        # on access (data/preprocess.py SpeechPreprocessor: RIR/noise/volume,
        # reference CommonPreprocessor `espnet2/train/preprocessor.py:283`)
        # transform: optional data/transform.py Transformation applied to
        # the loaded speech (wav or feats) on access — the `--preprocess_conf`
        # pipeline of the reference's LoadInputsAndTargets
        # (`espnet/utils/io_utils.py:14`); may change the length/feature
        # axes (e.g. fbank from raw), so speech_lengths() falls back to a
        # full first pass when set.
        if (wav_scp is None) == (feats_scp is None):
            raise ValueError("exactly one of wav_scp/feats_scp required")
        if wav_scp:
            self.speech = SoundScpReader(wav_scp)
        else:
            # dispatch npy / kaldi-ark / hdf5 by scp entry style
            from espnet_tpu_torch.data.kaldi_io import open_feats_scp

            self.speech = open_feats_scp(feats_scp)
        self.is_raw = wav_scp is not None
        self.text = read_2column_text(text) if text else None
        self.tokenizer = tokenizer
        self.converter = converter
        self.fs = fs
        # ST: auxiliary source-language transcript (`espnet2/st` data layout)
        self.src_text = read_2column_text(src_text) if src_text else None
        self.src_tokenizer = src_tokenizer or tokenizer
        self.src_converter = src_converter or converter
        self.multichannel = multichannel
        self.preprocessor = preprocessor
        self.transform = transform
        self.transform_train = transform_train

    def keys(self) -> List[str]:
        return list(self.speech.keys())

    def __len__(self):
        return len(self.speech)

    def _load_speech_raw(self, key: str) -> np.ndarray:
        if self.is_raw:
            wav, sr = self.speech[key]
            if sr != self.fs:
                raise ValueError(f"{key}: rate {sr} != {self.fs}")
            if wav.ndim > 1 and not self.multichannel:
                wav = wav[:, 0]
            elif wav.ndim == 1 and self.multichannel:
                wav = wav[:, None]
            wav = wav.astype(np.float32)
            if self.preprocessor is not None:
                wav = self.preprocessor(wav, uid=key)
            return wav
        return self.speech[key].astype(np.float32)

    def _load_speech(self, key: str) -> np.ndarray:
        wav = self._load_speech_raw(key)
        if self.transform is not None:
            wav = np.asarray(
                self.transform(wav, train=self.transform_train, uttid=key),
                np.float32,
            )
        return wav

    def __getitem__(self, key: str) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"speech": self._load_speech(key)}
        if self.text is not None:
            toks = self.tokenizer.text2tokens(self.text[key])
            out["text"] = np.asarray(self.converter.tokens2ids(toks), np.int32)
        if self.src_text is not None:
            toks = self.src_tokenizer.text2tokens(self.src_text[key])
            out["src_text"] = np.asarray(
                self.src_converter.tokens2ids(toks), np.int32
            )
        return out

    def speech_lengths(self) -> Dict[str, int]:
        """First-pass lengths (samples or frames) — used by the sampler.
        Reads headers only for wav (cheap); full read for npy. With an
        on-access transform the output length is transform-dependent, so
        this becomes a real first pass (deterministic eval-mode lengths) —
        the reference pays the same cost in its shape-file stage
        (`egs2/TEMPLATE/asr1/asr.sh` stage 10 collect-stats)."""
        out = {}
        if self.transform is not None:
            for k in self.speech.keys():
                x = self.transform(
                    self._load_speech_raw(k), train=False, uttid=k)
                out[k] = int(np.asarray(x).shape[0])
            return out
        for k in self.speech.keys():
            if self.is_raw:
                import wave as wave_mod

                path = self.speech.data[k]
                try:
                    with wave_mod.open(path) as w:
                        out[k] = w.getnframes()
                except Exception:
                    out[k] = len(self.speech[k][0])
            else:
                out[k] = self.speech[k].shape[0]
        return out

    def text_lengths(self) -> Dict[str, int]:
        return {
            k: len(self.tokenizer.text2tokens(v)) for k, v in self.text.items()
        }


class EnhDataset:
    """Mixture + per-speaker reference wavs for enhancement/separation.

    Data-dir layout mirrors the reference enh recipes
    (`egs2/TEMPLATE/enh1`): wav.scp = mixture, spk1.scp..spkN.scp =
    reference sources. Emits speech_mix (n,) and speech_ref (n, n_spk)."""

    def __init__(self, data_dir, num_spk: int = 2, fs: int = 16000):
        from pathlib import Path

        dd = Path(data_dir)
        self.mix = SoundScpReader(dd / "wav.scp")
        self.refs = [
            SoundScpReader(dd / f"spk{i + 1}.scp") for i in range(num_spk)
        ]
        self.num_spk = num_spk
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.mix.keys())

    def __len__(self):
        return len(self.mix)

    def __getitem__(self, key: str) -> Dict[str, np.ndarray]:
        mix, sr = self.mix[key]
        if sr != self.fs:
            raise ValueError(f"{key}: rate {sr} != {self.fs}")
        out = {"speech_mix": mix.astype(np.float32)}
        if self.refs:
            refs = []
            for r in self.refs:
                wav, _ = r[key]
                refs.append(wav.astype(np.float32))
            n = len(mix)
            out["speech_ref"] = np.stack([w[:n] for w in refs], axis=1)
        return out

    def speech_lengths(self) -> Dict[str, int]:
        out = {}
        for k in self.mix.keys():
            import wave as wave_mod

            path = self.mix.data[k]
            try:
                with wave_mod.open(path) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.mix[k][0])
        return out


def collate(
    dataset, batch: Batch, fields=("speech", "text")
) -> Dict[str, np.ndarray]:
    """Assemble one padded batch: field -> (B, L_pad[, D]) + field_lengths."""
    items = [dataset[k] for k in batch.keys]
    out: Dict[str, np.ndarray] = {"keys": batch.keys}
    # token-aligned aux fields pad to the text shape; enhancement refs pad
    # to the mixture shape
    aliases = {"durations": "text", "pitch": "text", "energy": "text",
               "speech_ref": "speech_mix", "noise_ref": "speech_mix",
               "spk_labels": "speech", "src_speech": "speech"}
    for f in fields:
        if f not in items[0]:
            continue
        arrs = [it[f] for it in items]
        max_len = batch.pad_shapes.get(
            f, batch.pad_shapes.get(aliases.get(f, f), 0)
        ) or 0
        # aliased fields may exceed their anchor's padded shape (e.g. a VC
        # source longer than the target) — never truncate
        max_len = max(max_len, max(a.shape[0] for a in arrs))
        lengths = np.asarray([a.shape[0] for a in arrs], np.int32)
        trailing = arrs[0].shape[1:]
        buf = np.zeros((len(arrs), max_len, *trailing), arrs[0].dtype)
        for i, a in enumerate(arrs):
            buf[i, : a.shape[0]] = a
        out[f] = buf
        out[f + "_lengths"] = lengths
    return out



def process_topology():
    """(world size, rank) of the torch.distributed process group when it
    is initialised, else (1, 0): the port's jax.process_count() and
    jax.process_index()."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0

class EpochIterator:
    """Reproducible per-epoch batch iterator with background prefetch.

    Equivalent of `espnet2/iterators/sequence_iter_factory.py:34` (per-epoch
    seeded shuffle + DataLoader workers): collation runs in a thread pool a
    few batches ahead of the consumer so host IO overlaps device compute.
    """

    def __init__(
        self,
        dataset,
        batches: List[Batch],
        seed: int = 0,
        shuffle: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        fields=("speech", "text"),
    ):
        # num_shards=0 / shard_index=-1 mean "resolve from the process
        # group" (torch.distributed; single-process -> 1 shard)
        if num_shards <= 0 or shard_index < 0:
            world, rank = process_topology()
            if num_shards <= 0:
                num_shards = world
            if shard_index < 0:
                shard_index = rank
        self.dataset = dataset
        self.batches = shard_batches(batches, num_shards)
        self.seed = seed
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.fields = fields

    def num_steps(self) -> int:
        return len(self.batches) // self.num_shards

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        batches = (
            shuffle_batches(self.batches, self.seed, epoch)
            if self.shuffle
            else list(self.batches)
        )
        mine = batches[self.shard_index :: self.num_shards]
        if self.prefetch <= 0:
            for b in mine:
                yield collate(self.dataset, b, self.fields)
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            futures = []
            it = iter(mine)
            for _ in range(self.prefetch):
                b = next(it, None)
                if b is not None:
                    futures.append(pool.submit(collate, self.dataset, b, self.fields))
            while futures:
                out = futures.pop(0).result()
                b = next(it, None)
                if b is not None:
                    futures.append(pool.submit(collate, self.dataset, b, self.fields))
                yield out


class TSEDataset(EnhDataset):
    """EnhDataset + enrollment wav per utterance (enroll_spk1.scp),
    mirroring the reference TSE data layout
    (`espnet2/train/preprocessor.py` TSEPreprocessor)."""

    def __init__(self, data_dir, fs: int = 16000):
        from pathlib import Path

        super().__init__(data_dir, num_spk=1, fs=fs)
        self.enroll = SoundScpReader(Path(data_dir) / "enroll_spk1.scp")

    def __getitem__(self, key: str):
        out = super().__getitem__(key)
        wav, sr = self.enroll[key]
        if sr != self.fs:
            raise ValueError(f"{key}: enroll rate {sr} != {self.fs}")
        out["enroll"] = wav.astype(np.float32)
        return out

    def enroll_lengths(self):
        import wave as wave_mod

        out = {}
        for k in self.enroll.keys():
            try:
                with wave_mod.open(self.enroll.data[k]) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.enroll[k][0])
        return out


class SVSDataset:
    """Score-based singing corpus: speech + per-note phones/midi/frames
    (reference SVS data streams, `espnet2/svs/espnet_model.py:85`)."""

    def __init__(self, data_dir, converter, fs: int = 16000):
        from pathlib import Path

        dd = Path(data_dir)
        self.speech = SoundScpReader(dd / "wav.scp")
        self.labels = read_2column_text(dd / "label")
        self.midi = read_2column_text(dd / "midi")
        self.durations = read_2column_text(dd / "durations")
        self.converter = converter
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.speech.keys())

    def __len__(self):
        return len(self.speech)

    def __getitem__(self, key: str) -> Dict[str, np.ndarray]:
        wav, sr = self.speech[key]
        if sr != self.fs:
            raise ValueError(f"{key}: rate {sr} != {self.fs}")
        if wav.ndim > 1:
            wav = wav[:, 0]
        phones = self.labels[key].split()
        return {
            "speech": wav.astype(np.float32),
            "text": np.asarray(self.converter.tokens2ids(phones), np.int32),
            "midi": np.asarray([int(x) for x in self.midi[key].split()],
                               np.int32),
            "durations": np.asarray(
                [int(x) for x in self.durations[key].split()], np.int32
            ),
        }

    def speech_lengths(self) -> Dict[str, int]:
        import wave as wave_mod

        out = {}
        for k in self.speech.keys():
            try:
                with wave_mod.open(self.speech.data[k]) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.speech[k][0])
        return out

    def text_lengths(self) -> Dict[str, int]:
        return {k: len(v.split()) for k, v in self.labels.items()}


class ASRMixDataset:
    """Mixture speech + per-speaker transcripts (text_spk<i>), the
    multi-speaker ASR layout (`e2e_asr_mix.py`)."""

    def __init__(self, data_dir, tokenizer, converter, num_spk: int = 2,
                 fs: int = 16000):
        from pathlib import Path

        dd = Path(data_dir)
        self.speech = SoundScpReader(dd / "wav.scp")
        self.texts = [read_2column_text(dd / f"text_spk{i + 1}")
                      for i in range(num_spk)]
        self.tokenizer = tokenizer
        self.converter = converter
        self.num_spk = num_spk
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.speech.keys())

    def __len__(self):
        return len(self.speech)

    def __getitem__(self, key: str) -> Dict[str, np.ndarray]:
        wav, sr = self.speech[key]
        if sr != self.fs:
            raise ValueError(f"{key}: rate {sr} != {self.fs}")
        if wav.ndim > 1:
            wav = wav[:, 0]
        ids = [
            np.asarray(self.converter.tokens2ids(
                self.tokenizer.text2tokens(t[key])), np.int32)
            for t in self.texts
        ]
        u = max(len(x) for x in ids)
        # (U, S) layout: the collate pads axis 0, so tokens go first and
        # the speaker axis is the (fixed) trailing dim
        text = np.zeros((u, self.num_spk), np.int32)
        tlens = np.zeros((self.num_spk,), np.int32)
        for s, x in enumerate(ids):
            text[: len(x), s] = x
            tlens[s] = len(x)
        return {"speech": wav.astype(np.float32), "text": text,
                "text_spk_lengths": tlens}

    def speech_lengths(self) -> Dict[str, int]:
        import wave as wave_mod

        out = {}
        for k in self.speech.keys():
            try:
                with wave_mod.open(self.speech.data[k]) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.speech[k][0])
        return out

    def text_lengths(self) -> Dict[str, int]:
        return {
            k: max(len(self.tokenizer.text2tokens(t[k]))
                   for t in self.texts)
            for k in self.texts[0]
        }


class ASRMulEncDataset:
    """Multi-encoder ASR layout (`e2e_asr_mulenc.py`): one waveform per
    encoder stream (wav_enc<i>.scp) + a single transcript (text). Streams
    share the padded sample axis so the item is (N, E); per-stream true
    lengths ride in speech_stream_lengths (E,)."""

    def __init__(self, data_dir, tokenizer, converter,
                 num_encoders: int = 2, fs: int = 16000):
        from pathlib import Path

        dd = Path(data_dir)
        self.streams = [SoundScpReader(dd / f"wav_enc{i + 1}.scp")
                        for i in range(num_encoders)]
        self.text = read_2column_text(dd / "text")
        self.tokenizer = tokenizer
        self.converter = converter
        self.num_encoders = num_encoders
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.streams[0].keys())

    def __len__(self):
        return len(self.streams[0])

    def __getitem__(self, key: str) -> Dict[str, np.ndarray]:
        wavs = []
        for rd in self.streams:
            wav, sr = rd[key]
            if sr != self.fs:
                raise ValueError(f"{key}: rate {sr} != {self.fs}")
            if wav.ndim > 1:
                wav = wav[:, 0]
            wavs.append(wav.astype(np.float32))
        n = max(len(w) for w in wavs)
        speech = np.zeros((n, self.num_encoders), np.float32)
        slens = np.zeros((self.num_encoders,), np.int32)
        for e, w in enumerate(wavs):
            speech[: len(w), e] = w
            slens[e] = len(w)
        ids = np.asarray(self.converter.tokens2ids(
            self.tokenizer.text2tokens(self.text[key])), np.int32)
        return {"speech": speech, "speech_stream_lengths": slens,
                "text": ids}

    def speech_lengths(self) -> Dict[str, int]:
        import wave as wave_mod

        out = {}
        for k in self.keys():
            best = 0
            for rd in self.streams:
                try:
                    with wave_mod.open(rd.data[k]) as w:
                        best = max(best, w.getnframes())
                except Exception:
                    best = max(best, len(rd[k][0]))
            out[k] = best
        return out

    def text_lengths(self) -> Dict[str, int]:
        return {k: len(self.tokenizer.text2tokens(v))
                for k, v in self.text.items()}


class ChunkIterator:
    """Fixed-length chunk training iterator (enhancement).

    Behavioral spec: `espnet2/iterators/chunk_iter_factory.py:13`
    (ChunkIterFactory): utterances are cut into `chunk_length` windows with
    shift = chunk_shift_ratio * chunk_length and a per-epoch random start
    offset; chunks are pooled across utterances and emitted in fixed-size
    batches — every batch therefore has a single static shape
    (batch_size, chunk_length, ...), the XLA-friendliest possible stream.
    Time-aligned array fields (equal leading length) are chunked together;
    utterances shorter than one chunk are zero-padded up.
    """

    def __init__(
        self,
        dataset,
        keys: List[str],
        chunk_length: int,
        batch_size: int,
        chunk_shift_ratio: float = 0.5,
        seed: int = 0,
        fields: Optional[Tuple[str, ...]] = None,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.keys = list(keys)
        self.chunk_length = int(chunk_length)
        self.batch_size = int(batch_size)
        self.shift = max(1, int(chunk_length * chunk_shift_ratio))
        self.seed = seed
        self.fields = fields
        self.num_shards = num_shards
        self.shard_index = shard_index

    def num_steps(self) -> int:  # approximate (chunk counts vary per utt)
        return max(1, len(self.keys) // max(self.batch_size, 1))

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState((self.seed + epoch) % (2 ** 31))
        order = rng.permutation(len(self.keys))
        order = order[self.shard_index :: self.num_shards]
        pool: Dict[str, List[np.ndarray]] = {}
        pool_keys: List[str] = []
        cl = self.chunk_length

        def flush():
            n = min(len(v) for v in pool.values())
            take = (n // self.batch_size) * self.batch_size
            for i in range(0, take, self.batch_size):
                batch = {
                    f: np.stack(v[i : i + self.batch_size])
                    for f, v in pool.items()
                }
                batch["keys"] = pool_keys[i : i + self.batch_size]
                lead = next(iter(batch.values()))
                batch_out = {}
                for f, arr in batch.items():
                    if f == "keys":
                        continue
                    batch_out[f] = arr
                    batch_out[f + "_lengths"] = np.full(
                        (arr.shape[0],), cl, np.int32
                    )
                batch_out["keys"] = batch["keys"]
                yield batch_out
            for f in pool:
                pool[f] = pool[f][take:]
            del pool_keys[:take]

        for idx in order:
            key = self.keys[idx]
            data = self.dataset[key]
            arrays = {
                f: np.asarray(v)
                for f, v in data.items()
                if self.fields is None or f in self.fields
            }
            if not arrays:
                continue
            length = min(a.shape[0] for a in arrays.values())
            if length < cl:
                arrays = {
                    f: np.pad(a[:length],
                              [(0, cl - length)] + [(0, 0)] * (a.ndim - 1))
                    for f, a in arrays.items()
                }
                starts = [0]
            else:
                offset = int(rng.randint(0, self.shift))
                starts = list(range(offset, length - cl + 1, self.shift))
                if not starts:
                    starts = [0]
            for s in starts:
                for f, a in arrays.items():
                    pool.setdefault(f, []).append(a[s : s + cl])
                pool_keys.append(f"{key}:{s}")
            if pool and min(len(v) for v in pool.values()) >= self.batch_size:
                yield from flush()
        if pool and min(len(v) for v in pool.values()) >= self.batch_size:
            yield from flush()
