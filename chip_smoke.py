#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (found through CUDA_HOME, torch's CUDA_HOME or
PATH) and the repository checkout; imports espnet_tpu_torch, torch, numpy
and the standard library only (no JAX). Phases, each printing lines with
the elapsed seconds, and raising on failure (exit code other than 0):

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc compiles every espnet_tpu_torch/csrc/*.cu into one library
   (prints the ptxas register / shared-memory lines);
3. kernels: each kernel against its plain PyTorch version, timed with CUDA
   events beside the plain version, the bound (the larger of operations
   over peak and bytes over 3.35 TB/s) and, where one PyTorch call computes
   the same function, that call; each line also gives the kernel call's
   device time from torch.profiler (its kernels' sum), which the events
   exceed where the Python wrapper, not the card, sets the pace (in bf16
   every kernel but the CTC pair runs on tensor cores, float32 on the
   CUDA cores, so the float32 checks hold the parity mode; each line names
   the design that ran):
   the forward kernels at the serve
   phase's shapes and the bench's decode geometry (B=8, T=469 / M=3000),
   then all fifteen kernel entry points at the training shapes (rel-pos
   forward and backward at B=64, H=4, T=469, D=64; the pre-norm FFN forward
   with dropout 0.1 and its backward at M=64*469, F=2048; the FFN of
   `fused_ffn` forward and backward at the E-Branchformer's M=64*469,
   F=1024, and recorded beside it at the decoder's M=64*41, F=2048; flash
   attention forward at the transformer's B=64, H=4, T=469, D=64 with
   torch.nn.functional.scaled_dot_product_attention as a yardstick, and in
   bf16 its backward, a PyTorch recompute through `reference_attention`
   (no kernel), against autograd through that function; the CTC
   lattice pair at B=64, T=469, S=81 (the warp-per-utterance kernels),
   with torch.nn.functional.ctc_loss as a second oracle and yardstick, and
   at S=4096 (the block-per-utterance kernels), then the device time of the
   whole CTC loss (`ctc_loss_from_logits`, bf16 logits, V=5000) forward
   and backward beside the pair's; the conv sub-block's head and tail (split
   route) at M=64*469, D=256 with dropout 0.1 and the whole-module kernel
   at B=64, T=469, D=256, k=31 over ragged utterances of 1 to 469 frames,
   and at D=144, each forward and backward, beside the plain route's
   sub-block), in float32 and bfloat16; then shapes past the conv kernels
   (D 640, k 33) must raise;
4. for each of the five configurations at full width and depth (random
   weights from a seed; `espnet_tpu_torch.configs`): the bench conformer,
   the `transformer` (ESPnet's AISHELL-1 transformer widths), the
   `e_branchformer` (ESPnet's LibriSpeech-100 E-Branchformer widths), and
   the bench conformer with its conv sub-block through the head and tail
   kernels (`conformer_conv_split`) or the whole-module kernel
   (`conformer_conv_module`), each with a 6-layer decoder:
   a. serve: 4 requests of 4, 6, 9 and 12 s through Speech2Text with beam
      10 (SERVE_STEPS label steps at most, twice: the runs must agree);
      the launch counters must show the exact kernel launches of the
      one encode call and nothing else, and the float32 encoder output must
      match the plain versions';
   b. train parity: one float32 forward and backward on those 4 utterances
      (dropout and SpecAug off, TF32 off) with the kernels and with their
      plain versions: same loss, same gradients;
   c. train: the bench's training run (B=64 x 15 s, 40 labels, bf16,
      dropout 0.1, SpecAug on, fused_adam with warmuplr): 1 warm-up step
      and 3 timed steps through make_train_step; finite losses, no skipped
      step, moved parameters and the exact kernel launches per step;
5. gates: conformers of d_model 144 (head dim 36: the JAX package's gates
   send every kernel call to the plain versions), 384 (head dim 96, padded
   to the attention kernels' 128; the FFN kernels at D=384) and 512 (head
   dim 128) serve and take a train step, each kernel running exactly where
   its shape gate lets it (plain versions elsewhere);
6. cli: the repo's LibriSpeech-100 conformer recipe
   (egs/librispeech_100/conf/train_asr_conformer.yaml: 12 x 256, 4 heads,
   FFN 1024, kernel 31, a 6 x 2048 decoder, global MVN, bf16, adamw,
   accum_grad 4, SpecAug) through `espnet_tpu_torch.bin.asr_train` with its
   asr_args as recipe.py splits them, changed only in the token type
   (char), the epochs (2), the batch (16 utterances in place of batch_bins)
   and the log interval (1), on a synthetic corpus of 64 + 16 utterances of
   8-15 s: collect-stats (timed), 2 epochs, then a resume that must run
   epoch 3 alone, an epoch 4 traced by the trainer's `--run.profile_steps
   2` (device busy share and top kernels), then
   `espnet_tpu_torch.bin.asr_inference` on the
   validation set with the recipe's decode_args and 40 label steps at most;
   every step finite and not skipped, the experiment files, the n-best
   average against the float64 mean of the epoch files, and the exact
   launches of the rel-pos, pre-norm FFN and CTC kernels in training,
   validation and decoding; it prints the collect-stats time, each epoch's
   wall time, step_time, peak device memory and the decode RTF beside the
   card's name and power limit;
7. asr-variants: the rest of the ASR model at full width (bf16, random
   weights from seed 0), each case with its exact kernel launches:
   `conformer_interctc` and `transformer_interctc` (InterCTC at layer 6 of
   12, weight 0.3: the CTC pair twice a step, the stats
   `loss_interctc_layer6`, a float32 train step against the plain path;
   3 steps at B=64 and 2 at B=16 x 15 s), `conformer_ctc_only` (no decoder
   params, Speech2Text refuses, `ctc_greedy_decode` on the 4 requests'
   log-probs, 3 steps), `conformer_att_only` (no CTC head, no CTC launch,
   Speech2Text with CTC weight 0, 2 steps), `conformer_remat` on the plain
   and whole-module conv routes (a float32 B=16 step with remat equal to
   one without from the same parameters and generator: loss within 1e-6,
   gradients within relative L2 1e-5, the generator left in the same
   state; then 3 bf16 steps at B=64 each way, with peak memory and
   ms/step), and the `feats` (80-dim log-mel through a Kaldi feats.scp),
   `sliding_window` (window 400, hop 160) and `fused` (n_fft 512 and
   1024, 160 wide) frontends (serve with the float32 encoder output
   against the plain path, 2 steps at B=16, the encoder's input width the
   frontend's);
8. recipe: `python -m espnet_tpu_torch.bin.run --config
   egs/librispeech_100/conf/train_asr_conformer.yaml` in a temporary
   directory with printed overrides (a 16-utterance synthetic corpus,
   char tokens, test set test_clean, the `cli` phase's asr_args at 4
   encoder and 2 decoder layers, stages 1-12): every marker and stage
   file, the exact kernel launches of each
   CLI it runs (read from `ops/launches.py`'s log), the rel-pos attention,
   pre-norm FFN and CTC pair against their plain versions on two of the
   recipe's own micro-batches (T' below one tile), each with a float32
   train step with kernels against plain, each stage's wall and the
   decode RTF, then a second call that skips every stage;
9. trained-exp: the JAX-trained egs_work/synth_hard conformer (6 x 128,
   head dim 32, FFN 512) through `espnet_tpu_torch.bin.asr_inference` on
   its 300 test utterances with the recipe's decode_args (beam 5, CTC
   0.3, 60 label steps, batches of 30), in float32 and in bf16: every text
   equal to JAX's exp/decode_test/text, WER 0.0, the exact rel-pos and
   pre-norm FFN launches, the decode wall and RTF; then
   `espnet_tpu_torch.bin.asr_train --run.resume` on a copy of its JAX
   resume state (checkpoint.msgpack, epoch 30): one epoch-31 step on 4
   test utterances, finite, not skipped, parameters moved, launches
   exact. A missing file fails the phase;
10. streaming: the `streaming_conformer` configuration (the bench
   conformer's widths as a contextual-block encoder, block 40, hop 16,
   look-ahead 16; random weights from seed 0): (a) the float32 encoder's
   parallel and blockwise modes on the 4 requests, with kernels and with
   plain versions (1e-4), exact `fused_ffn` launches; (b) `fused_ffn`
   against its plain version at one block's 42 rows; (c) the device and
   host engines, greedy and beam 4, in chunks of 1600 samples: greedy
   equal to offline CTC greedy, the engines' beam results equal (and
   counted against the offline search), ms per 0.512 s quantum, the
   streaming RTF, `fused_ffn` launches per block; (d) a float32 train step
   with kernels against plain; (e) 3 bf16 steps at B=64 x 15 s with exact
   launches, ms/step and peak memory; (f)
   `espnet_tpu_torch.bin.asr_inference_streaming` in both engines on an
   experiment directory written by `CheckpointManager` from those weights;
11. transducer: the `transducer_conformer` RNN-T (the JAX TransducerConfig
   defaults, vocab 5000: 12 x 256 conformer, 1 x 256 LSTM prediction
   network, joint 320; random weights from seed 0): (a) the lattice pair
   `transducer_alphas` and `transducer_occupancy` against their plain
   versions in float32 at the training shape (B=8, T'=468, U=40, V=5000)
   and at a character-level shape (U=200, ragged lengths), each with the
   device time, the bound, the chain's T+U waves and the plain version's
   time, and U+1 = 1025 raising; (b) Speech2TextTransducer on the 4
   requests, greedy and mAES (beam 5, 3 expansions), float32, the kernel
   route's token ids equal to the plain encoder route's and scores within
   1e-4, wall and RTF, launches exact (12 rel-pos, 24 pre-norm FFN an
   encode); (c) a float32 train step with kernels against plain, then 3
   bf16 steps at B=8 x 15 s, U=40 (ms/step, audio-s/s, peak GiB; the pair
   once each a step); (d) `bin.asr_transducer_train` (2 encoder layers at
   full width) on a synthetic corpus, then `bin.asr_transducer_inference`
   greedy and mAES, each in process with its exact launches;
12. asr-families: the rest of what the JAX ASRModel selects, at full
   width (random weights from seed 0), each case with its exact kernel
   launches: (a) `configs.longformer_conformer` (the slice's main path:
   12 x 256 longformer, window 100; `fused_ffn` 24 an encode and 24 + 24
   a step, the CTC pair 1 + 1): beam 10 (SERVE_STEPS label steps) on the
   4 requests in float32, the kernel route's tokens equal to the plain
   route's and its encoder
   output within 1e-3, a float32 train step with kernels against plain,
   3 bf16 steps at B=64 x 15 s; (b) `configs.vgg_blstm_rnn` (v1
   VGG-BLSTMP + AttLoc): the same serve, 1 bf16 step at B=64 x 15 s;
   (c) the S4 decoder, sinc and multichannel (with and without DNN-WPE)
   frontends on the bench conformer at 2 layers (`configs.FAMILIES`):
   the same serve (the S4 decoder's `fused_ffn` 6 a decoder step, counted)
   and one bf16 step at B=16 x 15 s (the multichannel cases B=4); (d) `WindowStreamingASR` on the
   VGG-LSTM: one window equals the offline decode, then 0.512 s windows,
   timed; (e) `bin.asr_align` on synth_hard's 300 test utterances in a
   subprocess with its launch log, its `segments` equal to the plain
   route's;
13. asr-multi: Mask-CTC, multi-encoder and multi-speaker ASR and the
   neural LM at full width (the JAX configs' defaults, vocab 5000, random
   weights from seed 0; `espnet_tpu_torch.configs`): (a) `fused_ffn`
   forward and backward at the LM's rows (M=64*257, F=1024) and the HAN
   decoder's (M=64*41), the pre-norm FFN forward and backward at the
   three encoders' training rows (M=64*T'; the Mask-CTC conformer's
   F=2048, the asr_mix conformer's and the mulenc transformers' F=1024;
   swish 0.5, relu 1.0), rel-pos attention forward and backward at the
   conformers' T', flash attention at the mulenc encoders' T' and the MLM
   decoder's (B=64, T=40, full and ragged lengths), float32 and bf16, and
   `ctc_loss_from_log_probs` (B=64, T'=469, V=5000, U=40): its gradient
   with respect to the log-probs against its plain lattice's (each valid
   frame's sum -1, an infeasible utterance's 0), and through log_softmax
   against torch's ctc_loss; (b)
   `maskctc_conformer`, `mulenc_transformer` (each request as 2 streams,
   the clean wave and a noisier copy; beam 10, CTC 0.3) and
   `asr_mix_conformer` (2-speaker mixtures of the requests; greedy CTC a
   branch): serve the 4 requests in float32 with the kernel route's
   results equal to the plain route's and the encoder output within
   1e-3, a float32 train step with kernels against plain, 3 bf16 steps at
   B=64 x 15 s with 40 labels (ms/step, audio-s/s, peak GiB), each with
   its exact launches (the MLM decoder's flash attention a layer for each
   infilling call; the HAN decoder's `fused_ffn` a layer a search step;
   the S^2 CTC pairs a step); (c) `transformer_lm` (6 x 256, FFN 1024): a
   float32 step with kernels against plain, 3 bf16 steps at B=64 x 256
   tokens; then `bin.lm_train` (5 epochs on synth_hard's test text, its
   token list) and `bin.lm_calc_perplexity` in process with their
   launches, and `bin.asr_inference` on synth_hard's 300 test
   utterances without and with that LM (weight 0.3): WER and RTF of each,
   launches exact (`fused_ffn` 6 a call of the LM's score_step);
14. lm-fusion: the JAX-trained synth_hard conformer with LMs trained on
   its training transcripts (`data/train/text`): `bin.ngram_train`
   (3-gram) and `bin.lm_train` (a word RNN LM and a character RNN LM, 2 x
   256, 3 epochs) with their held-out perplexities on the test
   transcripts (`bin.lm_calc_perplexity`), then `bin.asr_inference` on
   the first 50 test utterances (a fixed subset: the host searches) with
   no LM, the n-gram, the look-ahead word LM, the multi-level LM, the
   time-synchronous search and it with the n-gram (weights 0.3): WER, RTF
   and LM score steps of each; float32 texts on the kernel route equal to
   the plain route's, the n-gram decode's first 4 texts the ones the CPU
   tests pin, launches exact;
15. translation: flash attention forward at MT's training shape (B=64,
   H=4, T=128 ragged 16-128, D=64) and the pre-norm FFN forward and
   backward at its rows (M=64*128, F=2048, relu, 1.0) against their plain
   versions in float32 and bf16; `mt_transformer` (the JAX `MTConfig`
   defaults: a 6 x 256 token encoder, a 6 x 2048 decoder, vocab 5000 each
   side) serving 16 sentences (beam 10, 64 steps) and
   `st_conformer` (bench.py's conformer with the ST heads: a CTC head over
   the source vocabulary, asr_weight 0.3, mtlalpha 1.0) serving the 4
   requests (beam 10, SERVE_STEPS steps), each in float32 with the kernel
   route's results equal to the plain route's, a float32 train step with
   kernels against plain, 3 bf16 steps (MT at B=64 ragged pairs of 16-128
   tokens;
   ST at B=64 x 15 s, 40 target and 40 source labels), exact launches;
   then in-process `bin.mt_train` / `bin.mt_inference`, `bin.st_train` /
   `bin.st_inference` and `bin.slu_train` / `bin.slu_inference` on
   synthetic corpora (and `slu_inference` on synth_hard's 50 utterances:
   intent accuracy 1.0), each with its exact launches;
16. ssl: the SSL and Whisper parts of the ASR model and HuBERT
   pretraining at the published widths (random weights from seed 0;
   `espnet_tpu_torch.configs`): (a) flash attention forward at HuBERT's
   training shape (B=64, H=4, T=1876, D=64: 15 s at hop 128, no
   subsampling) and the pre-norm FFN forward and backward at its rows
   (M=64*1876, F=1024, relu 1.0, dropout 0.1), float32 and bf16, against
   their plain versions; (b) `ssl_conformer` (the frozen wav2vec2-base /
   HuBERT-base trunk through the S3PRL featurizer into bench.py's
   conformer; 12 rel-pos and 24 pre-norm FFN launches an encode),
   `wav2vec2_ctc` (that trunk fine-tuned as the encoder: the CTC pair
   only) and `whisper_base` (no kernel; its `score_step` with a 448-row
   cache against the teacher-forced log-probs): the 4 requests served in
   float32 (beam 10, SERVE_STEPS steps) with the kernel route's results
   equal to the plain route's and the encoder output within 1e-3, a
   float32 train step with kernels against plain (the frozen trunk gets
   no gradient),
   3 bf16 steps at B=64 x 15 s (for wav2vec2_ctc, whose trunk is
   fine-tuned, the largest power of two that fits: 68.6 GiB) with
   ms/step, audio-s/s, peak GiB and exact launches; (c) `hubert_pretrain` (6 x 256, FFN 1024): a float32
   step with kernels against plain, 3 bf16 steps at B=64 x 15 s, flash
   and the pre-norm FFN once a layer a step; (d) in-process
   `bin.hubert_train` (one epoch on 16 synthetic utterances: k-means
   centroids, labels, checkpoint), `bin.convert_hf` on a full-width
   wav2vec2-base-layout `.safetensors` file (float32) and a whisper-base
   one (float16) that the phase writes under HF's key names, and
   `bin.asr_train --run.init_param` from each, the transferred weights
   equal to the source; each with its exact launches;
17. tts: the four TTS models without the GAN family at the JAX configs'
   widths (`configs.tts_config`, random weights from seed 0, bf16): (a)
   flash attention at FastSpeech2's head dim 192 (B=32, H=2, T=626
   ragged: 10 s at hop 256; and its decoder at inference, B=4, T=2048)
   with SDPA's time beside it, and the pre-norm FFN forward and backward
   at D=384, F=1536, M=32*626, float32 and bf16, against their plain
   versions; (b) `fastspeech2`, `tacotron2`, `transformer` and `prodiff`
   each serving 4 requests of 120 tokens (the autoregressive two with
   the stop token off, to their 400-frame cap) with Griffin-Lim (32
   iterations), wall and RTF, the float32 synthesis with kernels against
   plain, a float32 train step with kernels against plain, then bf16
   steps at B=32 x 10 s with 120 tokens (ms/step, peak GiB), each with
   its exact launches (Tacotron2 none: JAX routes none of its modules to
   Pallas; the autoregressive two's float32 comparison over their first
   64 frames); (c) on a synthetic corpus: `bin.run_tts` (stages 1-9, a
   Tacotron2 of reduced width) with its subprocesses' launch logs, then
   in process the teacher flow from that Tacotron2:
   `tts_teacher_durations`, `tts_train` of a FastSpeech2 (2 + 2 layers at
   full width) on those durations, its `tts_inference` and
   `tts_scoring`;
18. gan: the GAN vocoders, VITS and JETS at the JAX task's and configs'
   defaults (random weights from seed 0, float32 as in JAX): (a) flash
   attention at VITS's head dim 96 (zero-padded to 128; B=16, H=2, T=120)
   and JETS's 128 (T=120 and its decoder's 626) with SDPA beside it, the
   pre-norm FFN at D=256, F=1024, M=16*626, float32 and bf16, and the CTC
   pair on JETS's forward-sum lattice (T=626; S=241, a warp per
   utterance, and S=401, a block per utterance) with torch's ctc_loss
   beside it, each against its plain version; (b) a timed train step of
   each vocoder (HiFiGAN V1, MelGAN, multi-band MelGAN, Parallel WaveGAN,
   StyleMelGAN) at B=16 x 8192 samples: ms/step, peak GiB, every loss
   finite; (c) VITS and JETS: the float32 text stack with kernels against
   plain, timed train steps at B=16 x 10 s with 120 tokens, the synthesis
   of 4 x 120 tokens, each with its exact launches; (d) on a synthetic
   corpus, in process: `vocoder_train`, `tts_train` of a FastSpeech2 and
   its `tts_inference --vocoder_dir`, `vits_train` / `vits_inference`,
   `jets_train` / `jets_inference` at reduced depth;
19. enh: enhancement and separation at `EnhConfig`'s defaults (conv
   encoder 256/20/10; 4 layers d 256, F 1024, k 15; random weights,
   float32 as in JAX, and bf16): (a) rel-pos forward and backward at
   B=8, H=4, T'=3199 (the task's 2 s chunks) and its forward at the
   serve batch's own B=4 and T', the pre-norm FFN on 8 x 3199 rows, the
   conv head, tail and whole-module kernels at k=15, flash at T'=3199
   with SDPA beside it, each against its plain version in float32 and
   bf16; (b) the
   conformer separator's float32 train step with kernels against plain
   (the loss and every gradient); (c) timed train steps at B=8 x 32,000
   samples of the conformer (plain and whole-module conv routes), the
   transformer and the TCN separators: ms/step, peak GiB, exact
   launches; (d) every other separator type at reduced depth, a forward
   and backward with a finite loss; (e) `enh_inference` on 4 mixtures of
   4-6 s: wall, RTF, exact launches, the waves of the kernel route
   against the plain route's; (f) on a synthetic corpus: in process
   `enh_train` -> `enh_inference` -> `enh_scoring` (a one-layer
   conformer at full width), and `run_enh` stages 1-7, whose heavy
   stages run the CLIs as subprocesses;
20. a `{"kernels": [...]}` JSON line (training shapes, bfloat16, the
   lattice pairs float32; launches from the timed train steps of the
   configuration whose path holds the kernel: the conformer's, the
   transformer's for flash attention, the E-Branchformer's for
   `fused_ffn`, the two conv routes' for theirs, the transducer's for its
   lattice pair, FastSpeech2's for the `flash_attention_d192` row and
   VITS's for the `flash_attention_d96` row: the same kernel at head dims
   192 and 96; the enhancement rows `*_t3199`, `*_enh_serve`, `*_k15`
   float32 at their shapes, their launches from the enh phase's float32
   steps and serve);
21. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor / fp32 cores
# float32 encoder output, kernels vs plain versions, 12 layers at full width
ENCODER_FP32_TOL = 1e-3
TOLERANCE = {  # (atol, rtol) of kernel vs plain
    "float32": (1e-4, 1e-4),
    "bfloat16": (3e-2, 1e-2),
}
# gradients, kernel vs plain, relative L2 error per tensor (float32: sums in
# another order; bf16: operands and outputs round to 8 bits)
GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}
# CTC lattice (float32 log space, |alpha| up to ~5e3 after 469 frames; the
# card's expf/logf round differently from PyTorch's): (atol, rtol)
CTC_TOLERANCE = (1e-3, 1e-5)
# the loss and its logits gradient against torch's own float32 ctc_loss: the
# log-space sums reach ~4e3 over 469 frames, where one float32 ulp is
# 2.4e-4, and that rounding becomes the occupancies' relative error (in
# torch's computation as much as in the port's)
CTC_LOSS_RTOL, CTC_GRAD_ATOL = 1e-5, 5e-3
# a valid frame's occupancy sums to 1 up to that same rounding of alpha +
# beta - log Z (it shifts all of a frame's states alike); a softmax term
# left in the log-prob gradient moves the sum by 1
CTC_OCC_SUM_ATOL = 1e-2
# the lattice's float32 vector work per state and frame: 3 exp, 1 log,
# 2 max, 3 subtractions, 3 additions (log-add-exp of three and the emission)
CTC_OPS_PER_STATE = 12
# the transducer lattice pair, float32: alpha and log Z as the CTC lattice
# (|alpha| reaches ~4e3 after 468 frames); the occupancies exponentiate
# alpha + emission + beta - log Z, sums near 8e3 where a float32 ulp is
# 4.9e-4: a few ulps of the exponent, as absolute error on a value in [0, 1]
RNNT_TOLERANCE, RNNT_OCC_ATOL = (1e-3, 1e-5), 2e-3
# float32 vector work per node: alpha, the log-add-exp of two (2 max, 2
# subtractions, 2 exp, 1 log, 2 additions, 1 select) and its 2 inputs'
# additions; the occupancy pass, beta's 12 and each occupancy's 3
# additions, clip (2) and exp
RNNT_ALPHA_OPS, RNNT_OCC_OPS = 12, 24
# the transducer's training geometry: B utterances of 15 s, 40 labels
RNNT_BATCH, RNNT_LABELS = 8, 40
# serve: the kernel route's scores against the plain route's (relative)
RNNT_SCORE_RTOL = 1e-4
# float32 train step of the full-width model, kernels vs plain versions
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_GRAD_REL_L2 = 1e-3
TRAIN_GRAD_FLOOR = 1e-3
# the bench's training geometry (bench.py): B utterances of 15 s, 40 labels
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_LABELS = 64, 15.0, 40
TRAIN_TIMED_STEPS = 3
# the ASR models' batch fields, in the order they take them
BATCH_KEYS = ("speech", "speech_lengths", "text", "text_lengths")

_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.2f}s] {phase}: {msg}", flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, {torch.cuda.device_count()} card(s); "
        f"nvidia-smi: {smi}")
    # float32 products in full float32, so the float32 checks mean it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from espnet_tpu_torch.ops.cuda_build import build_library, kernel_library

    t = time.perf_counter()
    path, output = build_library()
    kernel_library()
    for line in output.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas " + line.split("ptxas info    :")[-1].strip())
    log("build", f"{path} in {time.perf_counter() - t:.1f}s")


def time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10):
    """Device time of one call of fn: the sum over the kernels it launches
    (torch.profiler), or None where the profiler records none."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / 1e3 / iters if total > 0 else None


def compare(torch, name, dtype_name, got, want):
    atol, rtol = TOLERANCE[dtype_name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {dtype_name}: kernel output not finite")
    err = (got - want).abs()
    max_err = float(err.max())
    worst = float((err - rtol * want.abs()).max())
    ok = worst <= atol
    return max_err, ok, f"max |err| {max_err:.3e} (atol {atol}, rtol {rtol})"


def relpos_case(torch, b, t, dtype, lengths, seed):
    from espnet_tpu_torch.ops.relpos_attention import NEG

    g = torch.Generator(device="cpu").manual_seed(seed)
    h, d = 4, 64
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)  # noqa: E731
    q, k, v = mk(b, h, t, d), mk(b, h, t, d), mk(b, h, t, d)
    p = mk(h, 2 * t - 1, d)
    u = (0.1 * torch.randn(h, d, generator=g)).cuda()
    vb = (0.1 * torch.randn(h, d, generator=g)).cuda()
    valid = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    bias = torch.where(valid, 0.0, 2 * NEG).float()[:, None, None, :].cuda()
    args = (q, k, v, p, u, vb, bias)
    esize = q.element_size()
    flops = 6.0 * b * h * t * t * d
    nbytes = (4 * b * h * t * d + h * (2 * t - 1) * d) * esize \
        + b * t * 4 + 2 * h * d * 4
    return args, flops, nbytes


def ffn_case(torch, m, dtype, seed, d=256, f=2048):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, d, generator=g).to("cuda", dtype)
    lns = (1 + 0.1 * torch.randn(d, generator=g)).cuda()
    lnb = (0.1 * torch.randn(d, generator=g)).cuda()
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to("cuda", dtype)
    b2 = (0.1 * torch.randn(d, generator=g)).cuda()
    esize = x.element_size()
    flops = 4.0 * m * d * f
    nbytes = (2 * m * d + 2 * d * f) * esize + (3 * d + f) * 4
    return (x, lns, lnb, w1, b1, w2, b2), flops, nbytes


def bound(flops, nbytes, peak_flops):
    """(least time in ms, what bounds it) for the work on an H100."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# the kernels whose bf16 design runs on tensor cores (mma.sync); every
# other kernel, and every float32 one, runs on the CUDA cores
TENSOR_CORE_BF16 = {"relpos_attention", "relpos_attention_bwd",
                    "prenorm_ffn", "prenorm_ffn_bwd", "fused_ffn",
                    "fused_ffn_bwd", "flash_attention", "prenorm_glu",
                    "prenorm_glu_bwd", "postnorm_proj", "postnorm_proj_bwd",
                    "conv_module", "conv_module_bwd"}
# checked and timed like a kernel, but PyTorch operators, not a kernel
RECOMPUTE = {"flash_attention_bwd"}


def design(name, dtype_name, states=None):
    """Which cores the kernel `name` ran on in `dtype_name` (the CTC pair:
    and which of its designs, by the lattice's `states`)."""
    if name in RECOMPUTE:
        return "PyTorch recompute, no kernel"
    if states is not None:
        from espnet_tpu_torch.ops.ctc_lattice import design as ctc_design

        return f"CUDA cores, {ctc_design(states)}"
    tc = dtype_name == "bfloat16" and name in TENSOR_CORE_BF16
    return "tensor cores" if tc else "CUDA cores"


def report(name, label, dtype_name, how, ok, ms, plain_ms, bound_ms,
           bound_by, max_err, library_ms=None, dev_ms=None, states=None):
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    dev = "" if dev_ms is None else f" (device {dev_ms:.4f} ms)"
    log("kernels", f"{name} {label} {dtype_name} "
        f"[{design(name, dtype_name, states)}]: {how}; "
        f"kernel {ms:.4f} ms{dev}, "
        f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})"
        f"{'' if ok else '  <-- OUT OF TOLERANCE'}")
    if not ok:
        raise AssertionError(f"{name} {label} {dtype_name} disagrees with "
                             f"its plain version: {how}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dev_ms": dev_ms}


def check_kernel(torch, name, kernel, plain, args, flops, nbytes, dtype_name,
                 label, kwargs=None, iters=20):
    kwargs = kwargs or {}
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    max_err, ok, how = compare(torch, name, dtype_name, got, want)
    ms = time_ms(torch, lambda: kernel(*args, **kwargs), iters)
    plain_ms = time_ms(torch, lambda: plain(*args, **kwargs), iters)
    dev = device_ms(torch, lambda: kernel(*args, **kwargs))
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS[dtype_name])
    return report(name, label, dtype_name, how, ok, ms, plain_ms, bound_ms,
                  bound_by, max_err, dev_ms=dev)


def check_grads(torch, name, dtype_name, label, kernel, plain, args, n_diff,
                gout, flops, nbytes, iters=10):
    """Backward of `kernel` (the CUDA backward kernels through autograd)
    against autograd through `plain`, on the same inputs and cotangent."""
    def graph(fn):
        leaves = [a.detach().clone().requires_grad_(i < n_diff)
                  for i, a in enumerate(args)]
        return fn(*leaves), leaves[:n_diff]

    out_k, in_k = graph(kernel)
    out_p, in_p = graph(plain)

    def grads(out, inputs):
        return torch.autograd.grad(out, inputs, gout, retain_graph=True)

    got, want = grads(out_k, in_k), grads(out_p, in_p)
    torch.cuda.synchronize()
    worst, max_err = 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name} {label}: gradient not finite")
        gd, wd = g.double(), w.double()
        worst = max(worst, float((gd - wd).norm() / wd.norm().clamp(
            min=1e-4 * wd.numel() ** 0.5)))
        max_err = max(max_err, float((gd - wd).abs().max()))
    limit = GRAD_REL_L2[dtype_name]
    how = (f"worst relative L2 {worst:.3e} (limit {limit}), max |err| "
           f"{max_err:.3e}")
    ms = time_ms(torch, lambda: grads(out_k, in_k), iters)
    plain_ms = time_ms(torch, lambda: grads(out_p, in_p), iters)
    dev = device_ms(torch, lambda: grads(out_k, in_k))
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS[dtype_name])
    return report(name, label, dtype_name, how, worst <= limit, ms, plain_ms,
                  bound_ms, bound_by, max_err, dev_ms=dev)


def flash_case(torch, b, t, dtype, lengths, seed, h=4, d=64):
    """q, k, v and a key-padding bias; the operations count the valid keys
    only (a masked key's weight is exactly 0)."""
    from espnet_tpu_torch.ops.relpos_attention import NEG

    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)  # noqa: E731
    q, k, v = mk(b, h, t, d), mk(b, h, t, d), mk(b, h, t, d)
    valid = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    bias = torch.where(valid, 0.0, 2 * NEG).float()[:, None, None, :].cuda()
    flops = 4.0 * h * t * d * float(sum(lengths))
    nbytes = 4 * b * h * t * d * q.element_size() + b * t * 4
    return (q, k, v, bias), flops, nbytes, valid[:, None, None, :].cuda()


def fused_ffn_case(torch, m, dtype, seed, d=256, f=1024):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, d, generator=g).to("cuda", dtype)
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to("cuda", dtype)
    b2 = (0.1 * torch.randn(d, generator=g)).cuda()
    es = x.element_size()
    fwd = (4.0 * m * d * f, (2 * m * d + 2 * d * f) * es + (d + f) * 4)
    bwd = (10.0 * m * d * f, (3 * m * d + 4 * d * f) * es + (2 * f + d) * 4)
    return (x, w1, b1, w2, b2), fwd, bwd


CONV_D, CONV_K = 256, 31  # the bench conformer's conv sub-block


def glu_case(torch, m, dtype, seed, d=CONV_D):
    """The split route's head and tail inputs: x, x_res (M, D); LN scale
    and bias; W1 (D, 2D), b1; W2 (D, D), b2; and (flops, bytes) of the
    head and tail forward and backward."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x, xr = mk(m, d).to("cuda", dtype), mk(m, d).to("cuda", dtype)
    lns, lnb = (1 + 0.1 * mk(d)).cuda(), (0.1 * mk(d)).cuda()
    w1 = (mk(d, 2 * d) / d ** 0.5).to("cuda", dtype)
    b1 = (0.1 * mk(2 * d)).cuda()
    w2 = (mk(d, d) / d ** 0.5).to("cuda", dtype)
    b2 = (0.1 * mk(d)).cuda()
    es = x.element_size()
    work = {  # products; each input read once, each output written once
        "head": (4.0 * m * d * d, (2 * m * d + 2 * d * d) * es + 4 * d * 4),
        "head_bwd": (12.0 * m * d * d, (3 * m * d + 4 * d * d) * es
                     + 8 * d * 4),
        "tail": (2.0 * m * d * d, (3 * m * d + d * d) * es + 3 * d * 4),
        "tail_bwd": (4.0 * m * d * d, (3 * m * d + 2 * d * d) * es
                     + 5 * d * 4),
    }
    return (x, lns, lnb, w1, b1), (x, xr, lns, lnb, w2, b2), work


def module_case(torch, lengths, t, dtype, seed, d=CONV_D, k=CONV_K):
    """The whole-module route's inputs: x (B, T, D), the (B, T) mask of
    `lengths`, its 10 parameters, and (flops, bytes) of the forward and
    backward (every frame is computed, masked or not)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    b = len(lengths)
    x = mk(b, t, d).to("cuda", dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).cuda()
    params = [(1 + 0.1 * mk(d)).cuda(), (0.1 * mk(d)).cuda(),
              (mk(d, 2 * d) / d ** 0.5).to("cuda", dtype),
              (0.1 * mk(2 * d)).cuda(), (0.3 * mk(k, d)).to("cuda", dtype),
              (0.1 * mk(d)).cuda(), (1 + 0.1 * mk(d)).cuda(),
              (0.1 * mk(d)).cuda(), (mk(d, d) / d ** 0.5).to("cuda", dtype),
              (0.1 * mk(d)).cuda()]
    m, es = b * t, x.element_size()
    work = {
        "fwd": (6.0 * m * d * d + 2.0 * m * d * k,
                (2 * m * d + 3 * d * d + k * d) * es + m * 4 + 8 * d * 4),
        "bwd": (16.0 * m * d * d + 6.0 * m * d * k,
                (3 * m * d + 6 * d * d + 2 * k * d) * es + m * 4
                + 16 * d * 4),
    }
    return x, mask, params, work


def check_conv_kernels(torch, dn, dtype, label, m, b, t, lengths, drop,
                       grads, iters, kernel_size=CONV_K):
    """The six conv entry points against their plain versions at one shape:
    the head and tail at M = m rows, the whole module at (b, t) with
    `lengths` and depthwise kernel `kernel_size` (with `grads` at k 31 also
    at d 144); forwards, and with `grads` the backward kernels too. Returns
    the results by kernel name."""
    from espnet_tpu_torch.ops import conv_glu as tglu
    from espnet_tpu_torch.ops import conv_module as tcm

    out = {}
    head, tail, work = glu_case(torch, m, dtype, 12)
    kw = {"seed": 271828, "drop_rate": drop}
    lab = f"{label} M={m} D={CONV_D}"
    with torch.no_grad():
        out["prenorm_glu"] = check_kernel(
            torch, "prenorm_glu", tglu.prenorm_glu, tglu.prenorm_glu_plain,
            head, *work["head"], dn, lab, iters=iters)
        out["postnorm_proj"] = check_kernel(
            torch, "postnorm_proj", tglu.postnorm_proj,
            tglu.postnorm_proj_plain, tail, *work["tail"], dn,
            f"{lab} dropout {drop}", kw, iters=iters)
    gout = torch.randn(m, CONV_D, generator=torch.Generator().manual_seed(
        13)).to("cuda", dtype)
    if grads:
        out["prenorm_glu_bwd"] = check_grads(
            torch, "prenorm_glu_bwd", dn, lab, tglu.prenorm_glu,
            tglu.prenorm_glu_plain, head, 5, gout, *work["head_bwd"],
            iters=iters)
        out["postnorm_proj_bwd"] = check_grads(
            torch, "postnorm_proj_bwd", dn, f"{lab} dropout {drop}",
            lambda *a: tglu.postnorm_proj(*a, **kw),
            lambda *a: tglu.postnorm_proj_plain(*a, **kw), tail, 6, gout,
            *work["tail_bwd"], iters=iters)
    shapes = ((CONV_D, kernel_size), (144, 31)) \
        if grads and kernel_size == CONV_K else ((CONV_D, kernel_size),)
    for d, k in shapes:
        x, mask, params, work = module_case(torch, lengths, t, dtype, 14,
                                            d=d, k=k)
        kw = {"seed": -31337, "drop_rate": drop, "kernel_size": k}
        lab = (f"{label} B={b} T={t} D={d} k={k} lengths {min(lengths)}.."
               f"{max(lengths)} dropout {drop}")
        args = (x, *params)
        kern = lambda x, *p: tcm.conv_module(x, mask, *p, **kw)  # noqa: E731
        plain = lambda x, *p: tcm.conv_module_plain(  # noqa: E731
            x, mask, *p, **kw)
        with torch.no_grad():
            r = check_kernel(torch, "conv_module", kern, plain, args,
                             *work["fwd"], dn, lab, iters=iters)
        gout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            15)).to("cuda", dtype)
        rb = check_grads(torch, "conv_module_bwd", dn, lab, kern, plain,
                         args, 11, gout, *work["bwd"],
                         iters=iters) if grads else None
        if d == CONV_D:
            out.update({"conv_module": r, "conv_module_bwd": rb})
    return out


def plain_route_ms(torch, b, t, dtype, iters):
    """The plain route's whole conv sub-block (LN, the PyTorch conv module,
    FastDropout 0.1, residual) at (b, t, 256), k 31, the comparison for the
    kernel routes: (forward ms, forward and backward ms)."""
    from espnet_tpu_torch.models.conformer import ConvolutionModule
    from espnet_tpu_torch.models.layers import LayerNorm
    from espnet_tpu_torch.ops.dropout import fast_dropout

    conv = ConvolutionModule(CONV_D, CONV_K, dtype).cuda()
    norm = LayerNorm(CONV_D, dtype).cuda()
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(b, t, CONV_D, generator=gen).to("cuda", dtype) \
        .requires_grad_(True)
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")

    def fwd():
        return x + fast_dropout(conv(norm(x), mask), 0.1, gen)

    def fwd_bwd():
        fwd().backward(torch.ones_like(x))

    with torch.no_grad():
        f = time_ms(torch, fwd, iters)
    return f, time_ms(torch, fwd_bwd, iters)


def phase_kernels(torch, serve_b, serve_t):
    """The forward kernels against their plain versions at the serve and
    decode shapes."""
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for label, b, t in (("serve", serve_b, serve_t), ("bench", 8, 469)):
            # ragged key lengths, the longest = t
            lengths = [max(1, t - (t * i) // (2 * b)) for i in range(b)]
            args, flops, nbytes = relpos_case(torch, b, t, dtype, lengths, 0)
            with torch.no_grad():
                check_kernel(torch, "relpos_attention", relpos_attention,
                             relpos_attention_plain, args, flops, nbytes, dn,
                             f"{label} B={b} H=4 T={t} D=64")
        for label, m in (("serve", serve_b * serve_t), ("bench", 3000)):
            args, flops, nbytes = ffn_case(torch, m, dtype, 1)
            for act, scale in (("swish", 0.5), ("relu", 1.0)):
                with torch.no_grad():
                    check_kernel(
                        torch, "prenorm_ffn", prenorm_ffn, prenorm_ffn_plain,
                        args, flops, nbytes, dn,
                        f"{label} M={m} D=256 F=2048 {act} s={scale}",
                        {"activation": act, "residual_scale": scale})
        # the transformer's and E-Branchformer's encoder at the serve shapes
        lengths = [max(1, serve_t - (serve_t * i) // (2 * serve_b))
                   for i in range(serve_b)]
        args, flops, nbytes, _ = flash_case(torch, serve_b, serve_t, dtype,
                                            lengths, 7)
        with torch.no_grad():
            check_kernel(torch, "flash_attention", flash_attention,
                         flash_attention_plain, args, flops, nbytes, dn,
                         f"serve B={serve_b} H=4 T={serve_t} D=64")
        m = serve_b * serve_t
        args, (flops, nbytes), _ = fused_ffn_case(torch, m, dtype, 8)
        with torch.no_grad():
            check_kernel(torch, "fused_ffn", fused_ffn, fused_ffn_plain,
                         args, flops, nbytes, dn,
                         f"serve M={m} D=256 F=1024 swish",
                         {"activation": "swish"})
        # the conv routes' forwards (ragged requests, the longest = T')
        lengths = [max(1, serve_t - (serve_t * i) // (2 * serve_b))
                   for i in range(serve_b)]
        check_conv_kernels(torch, dn, dtype, "serve", m, serve_b, serve_t,
                           lengths, 0.0, grads=False, iters=20)


def check_conv_shapes_raise(torch):
    """Shapes past the conv kernels raise on the card, never run plain:
    D 640 for the head and tail, D 640 and k 33 for the whole module."""
    from espnet_tpu_torch.ops import conv_glu as tglu
    from espnet_tpu_torch.ops import conv_module as tcm

    head, tail, _ = glu_case(torch, 40, torch.float32, 17, d=640)
    cases = [("prenorm_glu D=640", lambda: tglu.prenorm_glu(*head)),
             ("postnorm_proj D=640", lambda: tglu.postnorm_proj(*tail))]
    for d, k in ((640, 31), (256, 33)):
        x, mask, params, _ = module_case(torch, [9, 4], 9, torch.float32, 18,
                                         d=d, k=k)
        cases.append((f"conv_module D={d} k={k}",
                      lambda x=x, mask=mask, p=params, k=k:
                      tcm.conv_module(x, mask, *p, kernel_size=k)))
    for name, call in cases:
        try:
            call()
        except ValueError as e:
            log("kernels", f"{name} raises as it should: {e}")
        else:
            raise AssertionError(f"{name} ran; the kernels do not take it")


def ctc_case(torch, np, b, t, u, v, seed, s=None):
    """Logits (B, T, V) float32, labels (B, U) and lengths on the card, with
    the lattice inputs the loss builds from them; `s` cuts the lattice to
    its first s states (labels no longer than (s - 1) / 2)."""
    from espnet_tpu_torch.ops import ctc as tctc

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.randint(1, v - 1, (b, u))).cuda()
    in_lens = torch.tensor([t - (i % 7) * 9 for i in range(b)]).cuda()
    top = u if s is None else min(u, (s - 1) // 2)
    lab_lens = torch.tensor([top - (i % 5) for i in range(b)]).cuda()
    ext = tctc.extended_labels(labels)[:, :s]
    emit = tctc._emissions(logits, ext, torch.logsumexp(logits, -1))
    return logits, labels, in_lens, lab_lens, emit, tctc.transition_mask(ext)


def check_ctc_pair(torch, emit, skip, in_lens, lab_lens, label,
                   library_ms=(None, None), plain_iters=3):
    """ctc_alphas and ctc_gamma against their plain versions on one lattice
    (float32, CTC_TOLERANCE), each timed with CUDA events and by its device
    time. Returns the two kernels' results by name."""
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    t, b, s = emit.shape
    live = float(in_lens.clamp(0, t).sum()) * s  # frames past a length freeze
    atol, rtol = CTC_TOLERANCE

    def ctc_compare(got, want):
        err = (got - want).abs()
        max_err = float(err[torch.isfinite(err)].max())
        ok = bool(torch.isfinite(got).all()) and float(
            (err - rtol * want.abs()).max()) <= atol
        return max_err, ok, (f"max |err| {max_err:.3e} (atol {atol}, rtol "
                             f"{rtol})")

    alphas, last = tlat.ctc_alphas(emit, skip, in_lens)
    pa, pl = tlat.ctc_alphas_plain(emit, skip, in_lens)
    gamma = tlat.ctc_gamma(emit, skip, in_lens, lab_lens, alphas)
    pg = tlat.ctc_gamma_plain(emit, skip, in_lens, lab_lens, pa)
    torch.cuda.synchronize()
    out = {}
    a_err, a_ok, a_how = ctc_compare(alphas, pa)
    a_err2, a_ok2, _ = ctc_compare(last, pl)
    call = lambda: tlat.ctc_alphas(emit, skip, in_lens)  # noqa: E731
    # bytes: emit read, alphas written, the skip mask, lengths, last
    bound_ms, bound_by = bound(CTC_OPS_PER_STATE * live, 2 * t * b * s * 4
                               + b * s + b * 8 + b * s * 4,
                               PEAK_FLOPS["float32"])
    out["ctc_alphas"] = report(
        "ctc_alphas", label, "float32", a_how, a_ok and a_ok2,
        time_ms(torch, call, 10), time_ms(torch, lambda: tlat.ctc_alphas_plain(
            emit, skip, in_lens), plain_iters),
        bound_ms, bound_by, max(a_err, a_err2), library_ms[0],
        dev_ms=device_ms(torch, call), states=s)
    g_err, g_ok, g_how = ctc_compare(gamma, pg)
    call = lambda: tlat.ctc_gamma(emit, skip, in_lens, lab_lens,  # noqa: E731
                                  alphas)
    # bytes: emit and alphas read, gamma written, the mask, both lengths
    bound_ms, bound_by = bound(CTC_OPS_PER_STATE * live, 3 * t * b * s * 4
                               + b * s + b * 16, PEAK_FLOPS["float32"])
    out["ctc_gamma"] = report(
        "ctc_gamma", label, "float32", g_how, g_ok, time_ms(torch, call, 10),
        time_ms(torch, lambda: tlat.ctc_gamma_plain(
            emit, skip, in_lens, lab_lens, alphas), plain_iters),
        bound_ms, bound_by, g_err, library_ms[1],
        dev_ms=device_ms(torch, call), states=s)
    return out


def phase_train_kernels(torch, np):
    """All six kernels at the training shapes, float32 and bfloat16 (the CTC
    lattice is float32 only). Returns the bfloat16 (CTC: float32) results by
    kernel name."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import ctc as tctc
    from espnet_tpu_torch.ops import ctc_lattice as tlat
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain,
                                                      reference_attention)
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    b, t, h, d = TRAIN_BATCH, 469, 4, 64
    m, f = b * t, 2048
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        es = 4 if dtype == torch.float32 else 2
        lengths = [t - (i % 9) * 7 for i in range(b)]
        args, flops, nbytes = relpos_case(torch, b, t, dtype, lengths, 2)
        label = f"train B={b} H={h} T={t} D={d}"
        with torch.no_grad():
            r = check_kernel(torch, "relpos_attention", relpos_attention,
                             relpos_attention_plain, args, flops, nbytes, dn,
                             label, iters=10)
        gout = torch.randn(b, h, t, d, generator=torch.Generator().manual_seed(
            3)).to("cuda", dtype)
        rb = check_grads(
            torch, "relpos_attention_bwd", dn, label, relpos_attention,
            relpos_attention_plain, args, 6, gout, 16.0 * b * h * t * t * d,
            (7 * b * h * t * d + 2 * h * (2 * t - 1) * d) * es + b * t * 4
            + b * h * t * 12)
        args, flops, nbytes = ffn_case(torch, m, dtype, 4)
        kw = {"activation": "swish", "residual_scale": 0.5,
              "drop_rate": 0.1, "seeds": (20240601, -77)}
        label = f"train M={m} D=256 F={f} swish s=0.5 dropout 0.1"
        with torch.no_grad():
            rf = check_kernel(torch, "prenorm_ffn", prenorm_ffn,
                              prenorm_ffn_plain, args, flops, nbytes, dn,
                              label, kw, iters=5)
        gout = torch.randn(m, 256, generator=torch.Generator().manual_seed(
            5)).to("cuda", dtype)
        rfb = check_grads(
            torch, "prenorm_ffn_bwd", dn, label,
            lambda *a: prenorm_ffn(*a, **kw),
            lambda *a: prenorm_ffn_plain(*a, **kw), args, 7, gout,
            10.0 * m * 256 * f, (3 * m * 256 + 4 * 256 * f) * es
            + (4 * 256 + 2 * f) * 4, iters=5)
        # fused_ffn: the E-Branchformer's macaron FFN rows, then the
        # decoder's training rows (recorded for a later routing decision)
        for role, rows, f2, act in (("e_branchformer", m, 1024, "swish"),
                                    ("decoder", b * (TRAIN_LABELS + 1), 2048,
                                     "relu")):
            args, (flops, nbytes), (bflops, bbytes) = fused_ffn_case(
                torch, rows, dtype, 9, f=f2)
            kw = {"activation": act, "drop_rate": 0.1, "seed": 314159}
            label = f"train {role} M={rows} D=256 F={f2} {act} dropout 0.1"
            with torch.no_grad():
                ff = check_kernel(torch, "fused_ffn", fused_ffn,
                                  fused_ffn_plain, args, flops, nbytes, dn,
                                  label, kw, iters=5)
            gout = torch.randn(rows, 256, generator=torch.Generator()
                               .manual_seed(10)).to("cuda", dtype)
            ffb = check_grads(
                torch, "fused_ffn_bwd", dn, label,
                lambda *a: fused_ffn(*a, **kw),
                lambda *a: fused_ffn_plain(*a, **kw), args, 5, gout, bflops,
                bbytes, iters=5)
            if role == "e_branchformer" and dtype == torch.bfloat16:
                main.update({"fused_ffn": ff, "fused_ffn_bwd": ffb})
        # flash attention: the transformer's encoder, ragged keys
        lengths = [t - (i % 9) * 7 for i in range(b)]
        args, flops, nbytes, valid = flash_case(torch, b, t, dtype, lengths,
                                                11)
        label = f"train B={b} H={h} T={t} D={d}"
        with torch.no_grad():
            fa = check_kernel(torch, "flash_attention", flash_attention,
                              flash_attention_plain, args, flops, nbytes, dn,
                              label, iters=10)
            fa["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *args[:3], attn_mask=valid), 10)
        log("kernels", f"flash_attention {label} {dn}: library "
            f"(scaled_dot_product_attention, boolean key mask) "
            f"{fa['library_ms']:.4f} ms")
        if dtype == torch.bfloat16:
            # its backward: the recompute through reference_attention (the
            # forward's two products and the backward's four, valid keys)
            gout = torch.randn(b, h, t, d, generator=torch.Generator()
                               .manual_seed(12)).to("cuda", dtype)
            check_grads(torch, "flash_attention_bwd", dn, label,
                        flash_attention, reference_attention, args, 3, gout,
                        3 * flops, 7 * b * h * t * d * es + b * t * 4)
        if dtype == torch.bfloat16:
            main.update({"relpos_attention": r, "relpos_attention_bwd": rb,
                         "prenorm_ffn": rf, "prenorm_ffn_bwd": rfb,
                         "flash_attention": fa})
        # the conv routes: ragged utterances of 1 frame to T
        lengths = [t, 1] + [t - (i % 9) * 7 for i in range(2, b)]
        conv = check_conv_kernels(torch, dn, dtype, "train", m, b, t,
                                  lengths, 0.1, grads=True, iters=5)
        if dtype == torch.bfloat16:
            main.update(conv)
            fwd_ms, step_ms = plain_route_ms(torch, b, t, dtype, 5)
            log("kernels", f"plain conv sub-block (LN, PyTorch conv module, "
                f"FastDropout, residual) train B={b} T={t} D={CONV_D} "
                f"k={CONV_K} {dn}: forward {fwd_ms:.4f} ms, forward and "
                f"backward {step_ms:.4f} ms")
    check_conv_shapes_raise(torch)

    # the CTC lattice pair, float32, S = 2*40+1 (the warp-per-utterance
    # route), with torch's own CTC as a yardstick
    u, v = TRAIN_LABELS, 5000
    logits, labels, in_lens, lab_lens, emit, skip = ctc_case(
        torch, np, b, t, u, v, 6)
    s = 2 * u + 1
    label = f"train B={b} T={t} S={s}"
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach() \
        .requires_grad_(True)
    lib_loss = F.ctc_loss(lp, labels, in_lens, lab_lens, blank=0,
                          reduction="sum", zero_infinity=True)
    lib_fwd_ms = time_ms(torch, lambda: F.ctc_loss(
        lp, labels, in_lens, lab_lens, blank=0, reduction="sum",
        zero_infinity=True), 10)
    lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_loss, lp, retain_graph=True), 10)
    pair = check_ctc_pair(torch, emit, skip, in_lens, lab_lens, label,
                          (lib_fwd_ms, lib_bwd_ms))
    main.update(pair)
    # the block-per-utterance route at the kernels' largest S
    big = tlat.max_states()
    _, _, b_in, b_lab, b_emit, b_skip = ctc_case(torch, np, b, t, big // 2,
                                                 v, 16, s=big)
    check_ctc_pair(torch, b_emit, b_skip, b_in, b_lab,
                   f"train B={b} T={t} S={big}")
    del b_emit, b_skip

    # the whole CTC loss around the pair at the bench shape, bf16 logits:
    # the V-wide log-sum-exp, gather, softmax and scatter around the lattice
    xb = logits.bfloat16().requires_grad_(True)

    def loss_fwd():
        return tctc.ctc_loss(xb, labels, in_lens, lab_lens, reduction="sum")

    def loss_fwd_bwd():
        torch.autograd.grad(loss_fwd(), xb)

    with torch.no_grad():
        fwd_dev = device_ms(torch, loss_fwd)
    step_dev = device_ms(torch, loss_fwd_bwd)
    step_ms = time_ms(torch, loss_fwd_bwd, 10)
    lattice_dev = sum(pair[k]["dev_ms"] or 0.0 for k in pair)
    log("kernels", f"ctc_loss_from_logits {label} V={v} bfloat16 logits: "
        f"forward and backward {step_ms:.4f} ms (device {step_dev:.4f} ms; "
        f"forward alone {fwd_dev:.4f} ms), of which the lattice pair "
        f"{lattice_dev:.4f} ms of device time")
    del xb

    # torch's own CTC as a second oracle for the loss and its gradient
    x = logits.clone().requires_grad_(True)
    loss = tctc.ctc_loss(x, labels, in_lens, lab_lens, reduction="sum")
    loss.backward()
    lib_grad, = torch.autograd.grad(lib_loss, lp)
    y = logits.clone().requires_grad_(True)
    (torch.log_softmax(y, -1).transpose(0, 1) * lib_grad).sum().backward()
    loss, lib_loss = float(loss.detach()), float(lib_loss.detach())
    loss_dev = abs(loss - lib_loss) / abs(lib_loss)
    grad_dev = float((x.grad - y.grad).abs().max())
    grad_rel = float((x.grad - y.grad).norm() / y.grad.norm())
    log("kernels", f"ctc_loss {label} V={v} float32 vs "
        f"torch.nn.functional.ctc_loss: loss {loss:.4f} vs {lib_loss:.4f} "
        f"(relative {loss_dev:.2e}, limit {CTC_LOSS_RTOL}), d logits max "
        f"|dev| {grad_dev:.2e} (limit {CTC_GRAD_ATOL}), relative L2 "
        f"{grad_rel:.2e}")
    if loss_dev > CTC_LOSS_RTOL or grad_dev > CTC_GRAD_ATOL:
        raise AssertionError("the CTC loss disagrees with torch's ctc_loss")
    return main


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "relpos_attention": ("espnet_tpu_torch/csrc/relpos_attention.cu",
                         "espnet_tpu/ops/pallas_relpos_attention.py:821"),
    "relpos_attention_bwd": ("espnet_tpu_torch/csrc/relpos_attention.cu",
                             "espnet_tpu/ops/pallas_relpos_attention.py:712"),
    "prenorm_ffn": ("espnet_tpu_torch/csrc/prenorm_ffn.cu",
                    "espnet_tpu/ops/pallas_ffn.py:538"),
    "prenorm_ffn_bwd": ("espnet_tpu_torch/csrc/prenorm_ffn.cu",
                        "espnet_tpu/ops/pallas_ffn.py:384"),
    "ctc_alphas": ("espnet_tpu_torch/csrc/ctc_lattice.cu",
                   "espnet_tpu/ops/pallas_ctc.py:119"),
    "ctc_gamma": ("espnet_tpu_torch/csrc/ctc_lattice.cu",
                  "espnet_tpu/ops/pallas_ctc.py:150"),
    "fused_ffn": ("espnet_tpu_torch/csrc/ffn.cu",
                  "espnet_tpu/ops/pallas_ffn.py:285"),
    "fused_ffn_bwd": ("espnet_tpu_torch/csrc/ffn.cu",
                      "espnet_tpu/ops/pallas_ffn.py:137"),
    "flash_attention": ("espnet_tpu_torch/csrc/flash_attention.cu",
                        "espnet_tpu/ops/pallas_attention.py:133"),
    # the same kernel at FastSpeech2's head dim 192 (B=32, H=2, T=626)
    "flash_attention_d192": ("espnet_tpu_torch/csrc/flash_attention.cu",
                             "espnet_tpu/ops/pallas_attention.py:133"),
    # and at VITS's head dim 96, zero-padded to 128 (B=16, H=2, T=120)
    "flash_attention_d96": ("espnet_tpu_torch/csrc/flash_attention.cu",
                            "espnet_tpu/ops/pallas_attention.py:133"),
    "prenorm_glu": ("espnet_tpu_torch/csrc/conv_glu.cu",
                    "espnet_tpu/ops/pallas_conv_glu.py:177"),
    "prenorm_glu_bwd": ("espnet_tpu_torch/csrc/conv_glu.cu",
                        "espnet_tpu/ops/pallas_conv_glu.py:137"),
    "postnorm_proj": ("espnet_tpu_torch/csrc/conv_glu.cu",
                      "espnet_tpu/ops/pallas_conv_glu.py:335"),
    "postnorm_proj_bwd": ("espnet_tpu_torch/csrc/conv_glu.cu",
                          "espnet_tpu/ops/pallas_conv_glu.py:294"),
    "conv_module": ("espnet_tpu_torch/csrc/conv_module.cu",
                    "espnet_tpu/ops/pallas_conv_module.py:305"),
    "conv_module_bwd": ("espnet_tpu_torch/csrc/conv_module.cu",
                        "espnet_tpu/ops/pallas_conv_module.py:252"),
    # the enhancement separators' shapes (`phase_enh`): rel-pos at the
    # conformer separator's T'=3199 (training) and the serve batch's T'
    # (`enh_serve`'s 4-6 s mixtures), flash at the transformer separator's
    # T'=3199, and the whole-module conv kernel at its depthwise kernel 15
    "relpos_attention_t3199": ("espnet_tpu_torch/csrc/relpos_attention.cu",
                               "espnet_tpu/ops/pallas_relpos_attention.py:821"),
    "relpos_attention_bwd_t3199": (
        "espnet_tpu_torch/csrc/relpos_attention.cu",
        "espnet_tpu/ops/pallas_relpos_attention.py:712"),
    "relpos_attention_enh_serve": (
        "espnet_tpu_torch/csrc/relpos_attention.cu",
        "espnet_tpu/ops/pallas_relpos_attention.py:821"),
    "flash_attention_t3199": ("espnet_tpu_torch/csrc/flash_attention.cu",
                              "espnet_tpu/ops/pallas_attention.py:133"),
    "conv_module_k15": ("espnet_tpu_torch/csrc/conv_module.cu",
                        "espnet_tpu/ops/pallas_conv_module.py:305"),
    "conv_module_bwd_k15": ("espnet_tpu_torch/csrc/conv_module.cu",
                            "espnet_tpu/ops/pallas_conv_module.py:252"),
    # no Pallas kernel: the JAX package's lax.scan pairs
    "transducer_alphas": ("espnet_tpu_torch/csrc/transducer_lattice.cu",
                          "espnet_tpu/ops/transducer.py:43"),
    "transducer_occupancy": ("espnet_tpu_torch/csrc/transducer_lattice.cu",
                             "espnet_tpu/ops/transducer.py:87"),
}
REQUEST_SECONDS = (4.0, 6.0, 9.0, 12.0)
SAMPLE_RATE = 16000
# label steps of the serves (random weights run every search to its cap):
# 24, not 40: the saved host time pays for the gan phase
SERVE_STEPS = 24


L = 12  # encoder layers of every configuration
CTC = {"ctc_alphas": 1, "ctc_gamma": 1}
CONFORMER = ({"relpos_attention": L, "prenorm_ffn": 2 * L},
             {"relpos_attention": L, "relpos_attention_bwd": L,
              "prenorm_ffn": 2 * L, "prenorm_ffn_bwd": 2 * L, **CTC})
# name (of espnet_tpu_torch.configs.ENCODERS): (launches per encode, per
# train step)
CONFIGS = {
    "conformer": CONFORMER,
    # flash attention has no backward kernel
    "transformer": ({"flash_attention": L, "prenorm_ffn": L},
                    {"flash_attention": L, "prenorm_ffn": L,
                     "prenorm_ffn_bwd": L, **CTC}),
    "e_branchformer": ({"fused_ffn": 2 * L, "relpos_attention": L},
                       {"fused_ffn": 2 * L, "fused_ffn_bwd": 2 * L,
                        "relpos_attention": L, "relpos_attention_bwd": L,
                        **CTC}),
    # the conformer's conv sub-block through the head and tail kernels, or
    # the whole-module kernel (configs.encoder_options)
    "conformer_conv_split": (
        {**CONFORMER[0], "prenorm_glu": L, "postnorm_proj": L},
        {**CONFORMER[1], "prenorm_glu": L, "prenorm_glu_bwd": L,
         "postnorm_proj": L, "postnorm_proj_bwd": L}),
    "conformer_conv_module": (
        {**CONFORMER[0], "conv_module": L},
        {**CONFORMER[1], "conv_module": L, "conv_module_bwd": L}),
}
# conformers at other widths: d 144 (head dim 36 and d_model 144 fail the
# JAX package's gates: plain everywhere, as there), d 384 (head dim 96,
# zero-padded to the attention kernels' 128; the FFN kernels at D=384) and
# d 512 (head dim 128); name: (overrides, per encode, per train step)
GATE_CONFIGS = {
    "gate_d144": ({"d_model": 144}, {}, dict(CTC)),
    "gate_d384": ({"d_model": 384}, *CONFORMER),
    "gate_d512": ({"d_model": 512}, *CONFORMER),
}
# rows of the kernels line that are another row's kernel at another shape
ROW_OF = {"flash_attention_d192": "flash_attention",
          "flash_attention_d96": "flash_attention",
          "relpos_attention_t3199": "relpos_attention",
          "relpos_attention_bwd_t3199": "relpos_attention_bwd",
          "relpos_attention_enh_serve": "relpos_attention",
          "flash_attention_t3199": "flash_attention",
          "conv_module_k15": "conv_module",
          "conv_module_bwd_k15": "conv_module_bwd"}
MAIN_PATH = {  # kernel: the configuration whose train run gives its launches
    "fused_ffn": "e_branchformer", "fused_ffn_bwd": "e_branchformer",
    "flash_attention": "transformer", "flash_attention_d192": "fastspeech2",
    "flash_attention_d96": "vits",
    **{k: "conformer_conv_split" for k in (
        "prenorm_glu", "prenorm_glu_bwd", "postnorm_proj",
        "postnorm_proj_bwd")},
    "conv_module": "conformer_conv_module",
    "conv_module_bwd": "conformer_conv_module",
    "transducer_alphas": "transducer",
    "transducer_occupancy": "transducer",
    "relpos_attention_t3199": "enh_conformer",
    "relpos_attention_bwd_t3199": "enh_conformer",
    "relpos_attention_enh_serve": "enh_serve",
    "flash_attention_t3199": "enh_transformer",
    "conv_module_k15": "enh_conformer_conv_module",
    "conv_module_bwd_k15": "enh_conformer_conv_module",
}


def requests(np):
    """One padded batch of seeded noise, one row per request."""
    rng = np.random.RandomState(0)
    lengths = np.array([int(s * SAMPLE_RATE) for s in REQUEST_SECONDS])
    speech = np.zeros((len(lengths), lengths.max()), np.float32)
    for i, n in enumerate(lengths):
        speech[i, :n] = 0.1 * rng.randn(n)
    return speech, lengths


def serve_shapes(cfg, lengths):
    """(B, T') the encoder sees for the padded batch."""
    from espnet_tpu_torch.models.subsampling import subsampled_length

    frames = int(max(lengths)) // cfg.hop_length + 1
    return len(lengths), subsampled_length(frames, cfg.subsampling_factor)


def build_model(cfg, options=None):
    """The port's model of `cfg`: the transducer for a TransducerConfig,
    Mask-CTC, multi-encoder or multi-speaker ASR, MT, ST or HuBERT for
    theirs, else the joint CTC/attention ASRModel."""
    from espnet_tpu_torch.models.asr import ASRModel
    from espnet_tpu_torch.models.asr_mix import ASRMixConfig, ASRMixModel
    from espnet_tpu_torch.models.hubert import HubertConfig, HubertModel
    from espnet_tpu_torch.models.maskctc import MaskCTCConfig, MaskCTCModel
    from espnet_tpu_torch.models.mt import MTConfig, MTModel
    from espnet_tpu_torch.models.mulenc import ASRMulEncModel, MulEncConfig
    from espnet_tpu_torch.models.st import STConfig, STModel
    from espnet_tpu_torch.models.transducer import (TransducerASRModel,
                                                    TransducerConfig)

    if isinstance(cfg, MTConfig):
        return MTModel(cfg)
    if isinstance(cfg, HubertConfig):
        return HubertModel(cfg)
    if isinstance(cfg, STConfig):
        return STModel(cfg)
    if isinstance(cfg, TransducerConfig):
        return TransducerASRModel(cfg, options)
    if isinstance(cfg, MaskCTCConfig):
        return MaskCTCModel(cfg, options)
    if isinstance(cfg, MulEncConfig):
        return ASRMulEncModel(cfg)
    if isinstance(cfg, ASRMixConfig):
        return ASRMixModel(cfg)
    return ASRModel(cfg, options)


def reset_counts():
    """Set every kernel's launch count to 0; returns the wrappers by name."""
    from espnet_tpu_torch.ops import launches

    return launches.reset()


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, np, cfg, device="cuda", tag="serve", options=None,
                inputs=None):
    """Serve the requests through Speech2Text; returns the launch counts of
    the served run. `inputs`: (speech, lengths) in place of the requests'
    waveforms (features, for input_type feats). (device="cpu" with a small
    config rehearses the phase where there is no card: the wrappers then
    take their plain versions.)"""
    import dataclasses

    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.models.asr import ASRModel, init_random_

    t = time.perf_counter()
    model = init_random_(ASRModel(cfg, options),
                         torch.Generator().manual_seed(0))
    s2t = Speech2Text(model, device=device, beam_size=10, ctc_weight=0.3,
                      max_steps=SERVE_STEPS)
    n_params = sum(p.numel() for p in model.parameters())
    log(tag, f"model built: {n_params} parameters, compute "
        f"{cfg.dtype}, {time.perf_counter() - t:.1f}s")
    speech, lengths = requests(np) if inputs is None else inputs
    t = time.perf_counter()
    warm = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    log(tag, f"warm-up run {time.perf_counter() - t:.2f}s")

    wrappers = reset_counts()
    t = time.perf_counter()
    results = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    audio = float(sum(REQUEST_SECONDS))
    log(tag, f"{len(results)} requests, {audio:.0f} s of audio: wall "
        f"{wall:.3f}s, RTF {wall / audio:.5f}; launches {counts}")
    for sec, r, w in zip(REQUEST_SECONDS, results, warm):
        print(f"  request {sec:4.1f}s: {len(r.token_ids)} tokens, "
              f"score {r.score:.4f}", flush=True)
        if r.nbest != w.nbest:
            raise AssertionError("two runs of the same requests disagree")
        if not all(np.isfinite(s) for _, s in r.nbest):
            raise AssertionError("non-finite hypothesis score")
        if any(s1 < s2 for (_, s1), (_, s2) in zip(r.nbest, r.nbest[1:])):
            raise AssertionError("n-best list not sorted by score")
        if not all(0 <= i < cfg.vocab_size for i in r.token_ids):
            raise AssertionError("token id out of range")
    sp = torch.from_numpy(speech).to(device)
    ln = torch.from_numpy(lengths).to(device)
    with torch.no_grad():
        t = time.perf_counter()
        model.encode(sp, ln)
        sync(torch, device)
        enc_s = time.perf_counter() - t
    log(tag, f"encode alone {enc_s:.4f}s of the {wall:.3f}s wall; the "
        f"rest is the beam search ({s2t.max_steps} label steps at most)")

    # the same weights in float32 and in bf16: the kernel path against the
    # plain path (asserted in float32, where the two differ only in rounding)
    for dtype in (torch.float32, torch.bfloat16):
        m = ASRModel(dataclasses.replace(cfg, dtype=dtype), options)
        m.load_state_dict(model.state_dict())
        m = m.to(device).eval()
        with torch.no_grad():
            enc_k, olens = m.encode(sp, ln)
            m.set_use_kernels(False)
            enc_p, _ = m.encode(sp, ln)
        sync(torch, device)
        valid = (torch.arange(enc_k.shape[1], device=device)[None, :]
                 < olens[:, None])[:, :, None]
        dev = float(((enc_k.float() - enc_p.float()).abs() * valid).max())
        scale = float((enc_p.float().abs() * valid).max())
        log(tag, f"encoder output {tuple(enc_k.shape)} {dtype}: kernels "
            f"vs plain max |dev| {dev:.3e} (max |out| {scale:.3f})")
        if not torch.isfinite(enc_k).all():
            raise AssertionError("encoder output not finite")
        if dtype == torch.float32 and dev > ENCODER_FP32_TOL:
            raise AssertionError(f"float32 encoder output deviates {dev:.3e}"
                                 f" > {ENCODER_FP32_TOL} from the plain path")
    return counts


def train_batch(np, b, seconds, u, vocab, seed):
    """Seeded noise waveforms with random labels (bench.py's batch)."""
    rng = np.random.RandomState(seed)
    n = [int(sec * SAMPLE_RATE) for sec in seconds]
    speech = np.zeros((b, max(n)), np.float32)
    for i, k in enumerate(n):
        speech[i, :k] = 0.1 * rng.randn(k)
    return {"speech": speech,
            "speech_lengths": np.array(n, np.int32),
            "text": rng.randint(1, vocab - 1, (b, u)).astype(np.int32),
            "text_lengths": np.full((b,), u, np.int32)}


def phase_train_parity(torch, np, cfg, device="cuda", tag="train-parity",
                       options=None, batch=None, keys=BATCH_KEYS):
    """One float32 forward and backward of the full-width model with the
    kernels and with their plain versions (dropout and SpecAug off), on
    the requests' waveforms with random labels or on `batch` (the model
    takes its fields `keys`). Returns the names of the parameters that got
    no gradient (a frozen SSL trunk's), the same on both routes."""
    import dataclasses

    from espnet_tpu_torch.models.asr import init_random_

    off = {"use_specaug": False} if hasattr(cfg, "use_specaug") else {}
    cfg = dataclasses.replace(cfg, dtype=torch.float32, dropout_rate=0.0,
                              **off)
    model = init_random_(build_model(cfg, options),
                         torch.Generator().manual_seed(1))
    model = model.to(device).train()
    if batch is None:
        batch = train_batch(np, len(REQUEST_SECONDS), REQUEST_SECONDS, 20,
                            cfg.vocab_size, 2)
    args = [torch.from_numpy(batch[k]).to(device) for k in keys]
    names = [n for n, _ in model.named_parameters()]
    results = {}
    for use in (True, False):
        model.set_use_kernels(use)
        loss, stats = model(*args)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        results[use] = (float(loss.detach()), grads)
    model.set_use_kernels(True)
    sync(torch, device)
    (lk, gk), (lp, gp) = results[True], results[False]
    unused = [n for n, g in zip(names, gk) if g is None]
    if unused != [n for n, g in zip(names, gp) if g is None]:
        raise AssertionError("the routes leave different parameters "
                             "without a gradient")
    names, gk, gp = zip(*((n, a, b) for n, a, b in zip(names, gk, gp)
                          if a is not None))
    loss_dev = abs(lk - lp) / abs(lp)
    total = float(torch.sqrt(sum((b.double() ** 2).sum() for b in gp)))
    whole = float(torch.sqrt(sum(((a.double() - b.double()) ** 2).sum()
                                 for a, b in zip(gk, gp)))) / total
    # each tensor's reference norm is floored at TRAIN_GRAD_FLOOR of the
    # whole gradient's: the key projections' bias gradients are 0 exactly
    # (softmax ignores a per-query constant) and hold only rounding noise
    devs = sorted(((float((a.double() - b.double()).norm()
                          / max(float(b.double().norm()),
                                TRAIN_GRAD_FLOOR * total)), n)
                   for n, a, b in zip(names, gk, gp)), reverse=True)
    log(tag, f"float32, B={args[0].shape[0]}: loss kernels "
        f"{lk:.6f} vs plain {lp:.6f} (relative {loss_dev:.2e}, limit "
        f"{TRAIN_FP32_LOSS_RTOL}); whole gradient relative L2 {whole:.2e} "
        f"(norm {total:.4e}); worst tensor {devs[0][0]:.2e} ({devs[0][1]}), "
        f"then {devs[1][0]:.2e} ({devs[1][1]}) over {len(devs)} tensors "
        f"(limit {TRAIN_FP32_GRAD_REL_L2})")
    if not all(np.isfinite(d) for d, _ in devs) or not np.isfinite(lk):
        raise AssertionError("non-finite loss or gradient")
    if (loss_dev > TRAIN_FP32_LOSS_RTOL or whole > TRAIN_FP32_GRAD_REL_L2
            or devs[0][0] > TRAIN_FP32_GRAD_REL_L2):
        raise AssertionError("the float32 train step with kernels deviates "
                             "from the plain versions'")
    return unused


def phase_train(torch, np, cfg, device="cuda", batch_size=TRAIN_BATCH,
                seconds=TRAIN_SECONDS, labels=TRAIN_LABELS,
                steps=TRAIN_TIMED_STEPS, tag="train", options=None,
                batch=None, need_stats=(), keys=BATCH_KEYS):
    """The bench's training run through make_train_step: 1 warm-up step,
    then `steps` timed steps. `batch` replaces the bench's waveforms (e.g.
    features; the model takes its fields `keys`); every step's stats must
    carry the keys `need_stats`. Returns the launch counts of the timed
    steps, the seconds a step and the peak
    device memory in GiB. (device="cpu" with a small config rehearses the
    phase where there is no card: the wrappers then take their plain
    versions.)"""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    t = time.perf_counter()
    model = init_random_(build_model(cfg, options),
                         torch.Generator().manual_seed(0))
    tx = build_optimizer("fused_adam", lr=2e-3, schedule="warmuplr",
                         warmup_steps=25000, d_model=cfg.d_model)
    step = make_train_step(model, tx, device=device, batch_keys=keys)
    state = TrainState.create(model, tx)
    if batch is None:
        batch = train_batch(np, batch_size, [seconds] * batch_size, labels,
                            cfg.vocab_size, 0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    log(tag, f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"compute {cfg.dtype}, dropout {cfg.dropout_rate}, SpecAug "
        f"{getattr(cfg, 'use_specaug', False)}, B={batch_size} x {seconds} s, U={labels}; "
        f"set-up {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    state, stats = step(state, batch, gen)
    sync(torch, device)
    log(tag, f"warm-up step {time.perf_counter() - t:.2f}s, loss "
        f"{float(stats['loss']):.4f}")
    before = state.params.clone()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    all_stats = []
    for _ in range(steps):
        state, stats = step(state, batch, gen)
        all_stats.append(stats)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else float("nan"))
    for i, st in enumerate(all_stats):
        vals = {k: float(v) for k, v in st.items()}
        print(f"  step {i + 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
        if not (np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])):
            raise AssertionError(f"train step {i + 1}: non-finite loss or "
                                 "gradient norm")
        if vals["skipped"] != 0.0:
            raise AssertionError(f"train step {i + 1} was skipped")
        missing = set(need_stats) - set(vals)
        if missing:
            raise AssertionError(f"train step {i + 1}: no stats {missing}")
    moved = float((state.params - before).abs().max())
    if not moved > 0.0:
        raise AssertionError("the train steps did not move the parameters")
    step_s = wall / steps
    log(tag, f"{steps} steps: {step_s * 1e3:.1f} ms/step, "
        f"{batch_size * seconds / step_s:.1f} audio-s/s, peak memory "
        f"{peak:.2f} GiB, max parameter move {moved:.3e}; launches {counts}")
    return counts, step_s, peak


def expected_counts(per_step: dict, steps: int) -> dict:
    want = {name: 0 for name in KERNELS if name not in ROW_OF}
    want.update({k: v * steps for k, v in per_step.items()})
    return want


def run_config(torch, np, name, cfg, per_encode, per_step, parity=True,
               train_batch_size=TRAIN_BATCH, train_steps=TRAIN_TIMED_STEPS,
               options=None):
    """Serve, (train parity,) train one configuration (`options`: its
    encoder options); checks the exact launches of the encode and of the
    timed train steps. Returns the train steps' launch counts."""
    serve = phase_serve(torch, np, cfg, tag=f"serve[{name}]",
                        options=options)
    want = expected_counts(per_encode, 1)
    if serve != want:
        raise AssertionError(f"{name}: one encode launched {serve}, "
                             f"expected {want}")
    if parity:
        phase_train_parity(torch, np, cfg, tag=f"train-parity[{name}]",
                           options=options)
    launches, _, _ = phase_train(torch, np, cfg,
                                 batch_size=train_batch_size,
                                 steps=train_steps, tag=f"train[{name}]",
                                 options=options)
    want = expected_counts(per_step, train_steps)
    if launches != want:
        raise AssertionError(f"{name}: {train_steps} train steps launched "
                             f"{launches}, expected {want}")
    return launches


# the cli phase: the repo's LibriSpeech-100 conformer recipe through the two
# command-line entry points, with these changes to its asr_args
CLI_CONF = "egs/librispeech_100/conf/train_asr_conformer.yaml"
CLI_CHANGES = {
    # no LibriSpeech and no `tokenizers` on the card: the corpus's characters
    "--data.token_type": "char",
    "--run.max_epoch": "2",
    "--data.batch_size": "16",  # in place of --data.batch_bins
    "--run.log_interval": "1",
}
CLI_DROPPED = ("--data.batch_bins",)
CLI_TRAIN_UTTS, CLI_VALID_UTTS = 64, 16
CLI_WORDS = (20, 37)  # 8-15 s of the synthetic corpus, LibriSpeech's lengths
CLI_SECONDS = 15.0  # the longest utterance
CLI_DECODE_STEPS = 40
CLI_KERNELS = ("relpos_attention", "relpos_attention_bwd", "prenorm_ffn",
               "prenorm_ffn_bwd", "ctc_alphas", "ctc_gamma")


def cli_argv(conf_args: str):
    """The conf's asr_args split as recipe.py splits them, with
    CLI_CHANGES applied (each printed)."""
    import shlex

    argv = shlex.split(conf_args)
    out, i = [], 0
    while i < len(argv):
        if argv[i] in CLI_DROPPED or argv[i] in CLI_CHANGES:
            log("cli", f"drop {argv[i]} {argv[i + 1]}")
            i += 2
            continue
        out += argv[i:i + 2]
        i += 2
    for flag, value in CLI_CHANGES.items():
        log("cli", f"set {flag} {value}")
        out += [flag, value]
    return out


def cli_batches(ds, data, batch_size):
    """The batches the task and the inference CLI build for `ds`."""
    from espnet_tpu_torch.data.sampler import build_batches

    return build_batches({"speech": ds.speech_lengths(),
                          "text": ds.text_lengths()},
                         batch_size=batch_size,
                         length_quantum=data.length_quantum,
                         text_quantum=data.text_quantum)


def cli_expected(train, valid, accum, layers):
    """Exact launches of one epoch of training and validation over these
    batches: per micro-batch of a train step (the largest divisor of the
    batch size not above accum_grad, as make_train_step splits it) each
    layer runs the rel-pos attention and two pre-norm FFNs forward and
    backward, and the CTC loss the lattice pair once; per validation batch
    the forwards and the alphas. Returns (launches, micro-batches)."""
    micro = 0
    for b in train:
        n = max(1, min(accum, len(b.keys)))
        while len(b.keys) % n:
            n -= 1
        micro += n
    nv = len(valid)
    want = {name: 0 for name in KERNELS if name not in ROW_OF}
    want.update({
        "relpos_attention": layers * (micro + nv),
        "relpos_attention_bwd": layers * micro,
        "prenorm_ffn": 2 * layers * (micro + nv),
        "prenorm_ffn_bwd": 2 * layers * micro,
        "ctc_alphas": micro + nv,
        "ctc_gamma": micro,
    })
    return want, micro


def check_launches(what, counts, want):
    if counts != want:
        raise AssertionError(f"cli: {what} launched {counts}, expected "
                             f"{want}")


def check_cli_ffn(torch, mcfg, utts):
    """The pre-norm FFN forward and backward against their plain versions
    at the recipe's widths (D=256, F=1024: no other phase runs F=1024) and
    a micro-batch's rows (`utts` utterances of CLI_SECONDS), as the macaron
    FFNs call them, in float32 and bfloat16."""
    from espnet_tpu_torch.models.subsampling import subsampled_length
    from espnet_tpu_torch.ops.stft import stft_frames_lengths

    frames = stft_frames_lengths(torch.tensor([int(CLI_SECONDS
                                                   * SAMPLE_RATE)]),
                                 mcfg.n_fft, mcfg.hop_length)
    tp = int(subsampled_length(frames, mcfg.subsampling_factor)[0])
    check_ffn_rows(torch, mcfg, utts * tp, f"cli M={utts}x{tp}")


# relu's derivative jumps at 0: where a pre-activation lies this close to
# it, float32 rounding in the kernel's sums or the plain version's puts it
# on either side, and the row's gradient moves with it (both are right to
# float32); the backward check holds every other row to its limit
RELU_KINK_BAND = 1e-6


def off_relu_kink(torch, args, gout):
    """`gout` with a zero cotangent on the rows of the pre-norm FFN's input
    whose pre-activation (LN(x) in x's dtype @ W1 + b1, in float64) lies
    within RELU_KINK_BAND of 0, and the number of those rows."""
    from espnet_tpu_torch.ops.ffn_common import LN_EPS

    x, lns, lnb, w1, b1 = args[:5]
    xn = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), lns,
                                        lnb, LN_EPS).to(x.dtype)
    h = xn.double() @ w1.double() + b1.double()
    rows = (h.abs() < RELU_KINK_BAND).any(dim=1)
    return torch.where(rows[:, None], torch.zeros_like(gout), gout), int(
        rows.sum())


def check_ffn_rows(torch, mcfg, m, label, activation="swish",
                   residual_scale=0.5):
    """The pre-norm FFN forward and backward against their plain versions
    at the model's D and F and `m` rows, as the model's layers call them
    (the macaron FFNs: swish, residual scale 0.5; the transformer layers:
    relu, 1.0; the model's dropout), in float32 and bfloat16."""
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)

    d, f = mcfg.d_model, mcfg.d_ff
    kw = {"activation": activation, "residual_scale": residual_scale,
          "drop_rate": mcfg.dropout_rate, "seeds": (20240601, -77)}
    label = (f"{label} D={d} F={f} {activation} s={residual_scale} dropout "
             f"{mcfg.dropout_rate}")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        es = 4 if dtype == torch.float32 else 2
        args, flops, nbytes = ffn_case(torch, m, dtype, 21, d=d, f=f)
        with torch.no_grad():
            check_kernel(torch, "prenorm_ffn", prenorm_ffn,
                         prenorm_ffn_plain, args, flops, nbytes, dn, label,
                         kw, iters=10)
        gout = torch.randn(m, d, generator=torch.Generator().manual_seed(
            22)).to("cuda", dtype)
        blabel = label
        if activation == "relu":
            gout, kinked = off_relu_kink(torch, args, gout)
            blabel = f"{label}, {kinked} rows at the kink held out"
        check_grads(torch, "prenorm_ffn_bwd", dn, blabel,
                    lambda *a: prenorm_ffn(*a, **kw),
                    lambda *a: prenorm_ffn_plain(*a, **kw), args, 7, gout,
                    10.0 * m * d * f, (3 * m * d + 4 * d * f) * es
                    + (4 * d + 2 * f) * 4)


def check_average(np, exp, epochs):
    """The averaged params file against the float64 mean of the epoch
    files, read back through the port's msgpack reader."""
    from espnet_tpu_torch.train.msgpack_io import flatten, load_tree

    ave = flatten(load_tree(exp / "valid.acc.ave.params.msgpack"))
    eps = [flatten(load_tree(exp / f"ep{e}.params.msgpack")) for e in epochs]
    for k, v in ave.items():
        want = (sum(np.asarray(t[k], np.float64) for t in eps)
                / len(eps)).astype(np.float32)
        if v.dtype != np.float32 or not np.array_equal(v, want):
            raise AssertionError(f"cli: averaged {k} is not the float64 "
                                 f"mean of epochs {epochs}")
    log("cli", f"valid.acc.ave.params.msgpack: {len(ave)} leaves, each the "
        f"float64 mean of epochs {epochs}")


def trace_breakdown(path, smi, top=6):
    """Device busy share and the top kernels of a torch.profiler chrome
    trace (the trainer's `--run.profile_steps` window); a trace without
    device time fails. Returns the device busy ms."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise AssertionError("cli: the profile trace has no events")
    start = min(e["ts"] for e in events)
    wall = max(e["ts"] + e["dur"] for e in events) - start
    dev_events = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    busy, end, by_name = 0.0, -1.0, {}
    for e in dev_events:
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        busy += max(0.0, hi - lo)
        end = max(end, hi)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    if not busy:
        raise AssertionError("cli: the profile trace shows no device time")
    log("cli", f"profiled window (under the profiler): wall "
        f"{wall / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle share "
        f"{1 - busy / wall:.3f} ({len(dev_events)} device events) [{smi}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.3f} ms  {name[:90]}", flush=True)
    return busy / 1e3


def phase_cli(torch, np, smi):
    """asr_train (2 epochs, a resume to epoch 3, a profiled epoch 4) and
    asr_inference with the LibriSpeech-100 conformer's asr_args and
    decode_args, checking the pre-norm FFN kernels at the recipe's F, the
    files, the losses, the average and the exact kernel launches."""
    import shlex
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_inference, asr_train
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.tasks.abs_task import pop_device
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.utils.config import load_yaml

    conf = load_yaml(CLI_CONF)["recipe"]
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        t = time.perf_counter()
        lo, hi = CLI_WORDS
        generate_corpus(ws / "train", n_utts=CLI_TRAIN_UTTS, min_words=lo,
                        max_words=hi, seed=0)
        generate_corpus(ws / "valid", n_utts=CLI_VALID_UTTS, min_words=lo,
                        max_words=hi, seed=1)
        log("cli", f"corpus of {CLI_TRAIN_UTTS} + {CLI_VALID_UTTS} "
            f"utterances ({lo}-{hi} words) in "
            f"{time.perf_counter() - t:.1f}s")
        exp = ws / "exp"
        argv = cli_argv(conf["asr_args"]) + [
            "--data.train_dir", str(ws / "train"),
            "--data.valid_dir", str(ws / "valid"),
            "--run.output_dir", str(exp), "--device", "cuda"]
        cfg = ASRTask.parse_config(pop_device(argv)[1])
        run, data, mcfg = cfg["run"], cfg["data"], cfg["model"]
        log("cli", f"model {mcfg.encoder_type} {mcfg.num_encoder_layers} x "
            f"{mcfg.d_model}, {mcfg.num_heads} heads, FFN {mcfg.d_ff}, kernel "
            f"{mcfg.conformer_kernel_size}, decoder {mcfg.num_decoder_layers} "
            f"x {mcfg.decoder_d_ff}, {mcfg.normalize}, {mcfg.dtype}, "
            f"SpecAug {mcfg.use_specaug}; optimizer {cfg['optim'].name}, "
            f"accum_grad {run.accum_grad}, batch {data.batch_size}")
        check_cli_ffn(torch, mcfg, data.batch_size // run.accum_grad)

        # collect-stats alone, timed; the training run reuses the stats
        t = time.perf_counter()
        asr_train.main(argv + ["--run.stats_only", "true"])
        torch.cuda.synchronize()
        stats_s = time.perf_counter() - t
        log("cli", f"collect-stats (with the token list and the datasets) "
            f"{stats_s:.2f}s")

        tokens = ASRTask.build_tokenizer(data, exp)
        conv = ASRTask.build_token_list(data, exp, tokens)
        ds_train = ASRTask.build_dataset(data, ws / "train", tokens, conv)
        ds_valid = ASRTask.build_dataset(data, ws / "valid", tokens, conv,
                                         train=False)
        valid = len(cli_batches(ds_valid, data, data.batch_size))
        per_epoch, micro = cli_expected(
            cli_batches(ds_train, data, data.batch_size),
            cli_batches(ds_valid, data, data.batch_size), run.accum_grad,
            mcfg.num_encoder_layers)
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_counts()
        t = time.perf_counter()
        _, trainer, model, _, _ = asr_train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        counts = {name: fn.launches for name, fn in wrappers.items()}
        want = {k: 2 * v for k, v in per_epoch.items()}
        log("cli", f"2 epochs in {train_s:.1f}s ({micro} micro-batches and "
            f"{valid} validation batches an epoch); launches {counts}")
        check_launches("2 epochs", counts, want)
        steps = trainer.step_log
        for epoch, st in steps:
            if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])):
                raise AssertionError(f"cli: a step of epoch {epoch} has a "
                                     f"non-finite loss or gradient norm: {st}")
            if st["skipped"] != 0.0:
                raise AssertionError(f"cli: a step of epoch {epoch} was "
                                     "skipped")
        rep = trainer.reporter.epochs
        for e in (1, 2):
            acc = rep[e].get("valid", {}).get("acc")
            if acc is None or not np.isfinite(acc):
                raise AssertionError(f"cli: no validation accuracy for "
                                     f"epoch {e}")
            log("cli", f"epoch {e}: wall {trainer.epoch_seconds[e]:.2f}s, "
                f"train loss {rep[e]['train']['loss']:.4f}, step_time "
                f"{rep[e]['train']['step_time'] * 1e3:.1f} ms, valid acc "
                f"{acc:.4f} [{smi}]")
        for name in ("config.yaml", "tokens.txt", "stats/feats_stats.npz",
                     "ep1.params.msgpack", "ep2.params.msgpack",
                     "valid.acc.best.params.msgpack",
                     "valid.acc.ave.params.msgpack", "checkpoint.pt"):
            if not (exp / name).exists():
                raise AssertionError(f"cli: {name} is missing")
        check_average(np, exp, [1, 2])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log("cli", f"{len(steps)} steps, every loss finite, none skipped; "
            f"peak device memory {peak:.2f} GiB [{smi}]")

        # resume: exactly one more epoch
        wrappers = reset_counts()
        t = time.perf_counter()
        _, trainer, _, _, _ = asr_train.main(argv + ["--run.max_epoch", "3"])
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        if sorted(trainer.epoch_seconds) != [3]:
            raise AssertionError(f"cli: the resumed run ran epochs "
                                 f"{sorted(trainer.epoch_seconds)}, not [3]")
        check_launches("the resumed epoch", counts, per_epoch)
        if not all(np.isfinite(st["loss"]) and st["skipped"] == 0.0
                   for e, st in trainer.step_log):
            raise AssertionError(f"cli: a resumed step failed")
        check_average(np, exp, [1, 2, 3])
        step3 = trainer.reporter.epochs[3]["train"]["step_time"] * 1e3
        log("cli", f"resumed at epoch 3: wall "
            f"{trainer.epoch_seconds[3]:.2f}s of {time.perf_counter() - t:.1f}s"
            f", step_time {step3:.1f} ms; launches exact [{smi}]")

        # one more epoch with the trainer's torch.profiler window: the
        # device's busy share over steps 2-3 and its kernels by time
        wrappers = reset_counts()
        asr_train.main(argv + ["--run.max_epoch", "4",
                               "--run.profile_steps", "2"])
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        check_launches("the profiled epoch 4", counts,
                       per_epoch)
        busy = trace_breakdown(exp / "profile" / "trace.json", smi) / 2
        log("cli", f"device busy {busy:.1f} ms a profiled step against the "
            f"unprofiled step_time {step3:.1f} ms of epoch 3: idle share "
            f"{1 - busy / step3:.3f} without the profiler's host cost "
            f"[{smi}]")

        # decode the validation set with the conf's decode_args
        dec = ws / "decode"
        dargs = shlex.split(conf["decode_args"]) + [
            "--max_steps", str(CLI_DECODE_STEPS)]
        wrappers = reset_counts()
        hyps = asr_inference.main(
            ["--exp_dir", str(exp), "--data_dir", str(ws / "valid"),
             "--output_dir", str(dec), "--device", "cuda"] + dargs)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        n_dec = len(cli_batches(
            ds_valid, data, int(dargs[dargs.index("--batch_size") + 1])))
        want = {name: 0 for name in KERNELS if name not in ROW_OF}
        want.update({"relpos_attention": mcfg.num_encoder_layers * n_dec,
                     "prenorm_ffn": 2 * mcfg.num_encoder_layers * n_dec})
        check_launches(f"decoding ({n_dec} batches)", counts,
                       want)
        keys = set(ds_valid.keys())
        text = dec / "text"
        written = {ln.split(" ", 1)[0] for ln in
                   text.read_text().splitlines()} if text.exists() else set()
        if set(hyps) != keys or written != keys:
            raise AssertionError(f"cli: decoding wrote text for "
                                 f"{len(written)} of {len(keys)} keys")
        for name in ("rtf.txt", "score_cer.txt"):
            if not (dec / name).exists():
                raise AssertionError(f"cli: decode wrote no {name}")
        rtf = (dec / "rtf.txt").read_text().strip()
        cer = (dec / "score_cer.txt").read_text().strip()
        log("cli", f"decoded {len(hyps)} utterances ({dargs}): {rtf}; "
            f"launches exact ({n_dec} encode batches) [{smi}]")
        log("cli", f"CER after 4 epochs (no gate): {cer}")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# the asr-variants phase: the rest of the ASR model at the bench conformer's
# (and the smoke transformer's) full widths, bf16, random weights from seed 0
VARIANT_BATCH = 16  # the smaller cases' B (x 15 s)
INTERCTC = {"interctc_layer_idx": (6,), "interctc_weight": 0.3}
NO_CTC = {k: v for k, v in CONFORMER[1].items() if k not in CTC}
# remat recomputes every block's forward kernels in the backward pass
REMAT_STEP = {**CONFORMER[1], "relpos_attention": 2 * L,
              "prenorm_ffn": 4 * L}
REMAT_FP32_LOSS_RTOL, REMAT_FP32_GRAD_REL_L2 = 1e-6, 1e-5
FRONTENDS = {  # case: (config overrides, the encoder's input width)
    "conformer_feats": ({"input_type": "feats"}, 80),
    "conformer_sliding_window": ({"input_type": "sliding_window",
                                  "win_length": 400, "hop_length": 160}, 400),
    "conformer_fused": ({"input_type": "fused", "n_fft": 512,
                         "fused_n_fft2": 1024}, 160),
}


def check_case_launches(name, what, counts, per, n):
    want = expected_counts(per, n)
    if counts != want:
        raise AssertionError(f"{name}: {what} launched {counts}, expected "
                             f"{want}")


def variant_model(torch, cfg, options=None):
    from espnet_tpu_torch.models.asr import ASRModel, init_random_

    return init_random_(ASRModel(cfg, options),
                        torch.Generator().manual_seed(0))


def check_remat_fp32(torch, np, cfg, options, tag):
    """One float32 forward and backward (dropout 0.1, SpecAug on, B=16 x
    15 s) with remat and one without, from the same parameters and
    generator state: the same loss and gradients, and the generator left
    in the same state."""
    import dataclasses

    from espnet_tpu_torch.models.asr import ASRModel

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    state = variant_model(torch, cfg, options).state_dict()
    batch = train_batch(np, VARIANT_BATCH, [TRAIN_SECONDS] * VARIANT_BATCH,
                        TRAIN_LABELS, cfg.vocab_size, 3)
    args = [torch.from_numpy(batch[k]).cuda() for k in
            ("speech", "speech_lengths", "text", "text_lengths")]
    out = {}
    for remat in (False, True):
        model = ASRModel(dataclasses.replace(cfg, remat_encoder=remat),
                         options)
        model.load_state_dict(state)
        model = model.cuda().train()
        gen = torch.Generator().manual_seed(7)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = model(*args, generator=gen)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()), [g.double() for g in grads],
                      gen.get_state(),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, loss
    (lp, gp, sp, mp), (lr, gr, sr, mr) = out[False], out[True]
    loss_dev = abs(lr - lp) / abs(lp)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in gp)))
    worst = max(float((a - b).norm() / max(float(b.norm()),
                                           TRAIN_GRAD_FLOOR * total))
                for a, b in zip(gr, gp))
    log(tag, f"float32 B={VARIANT_BATCH}, dropout {cfg.dropout_rate}, "
        f"SpecAug on: loss with remat {lr:.7f} vs without {lp:.7f} "
        f"(relative {loss_dev:.2e}, limit {REMAT_FP32_LOSS_RTOL}); worst "
        f"gradient relative L2 {worst:.2e} over {len(gp)} tensors (limit "
        f"{REMAT_FP32_GRAD_REL_L2}); generator state equal "
        f"{torch.equal(sr, sp)}; peak {mr:.2f} vs {mp:.2f} GiB")
    if (loss_dev > REMAT_FP32_LOSS_RTOL or worst > REMAT_FP32_GRAD_REL_L2
            or not torch.equal(sr, sp)):
        raise AssertionError(f"{tag}: the remat step is not the plain step")


def feats_inputs(torch, np, cfg, speech, lengths, ws):
    """The waveforms' 80-dim log-mel (the card's frontend), written to a
    Kaldi feats.scp by the port's kaldi_io and read back, padded:
    ((B, T, 80), frames)."""
    from espnet_tpu_torch.data.kaldi_io import (open_feats_scp,
                                                write_kaldi_ark_scp)
    from espnet_tpu_torch.ops.stft import log_mel_spectrogram

    with torch.no_grad():
        f, n = log_mel_spectrogram(
            torch.from_numpy(speech).cuda(),
            torch.from_numpy(lengths).cuda(),
            cfg.fs, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_mels)
    f, n = f.cpu().numpy(), n.cpu().numpy()
    keys = [f"utt{i:03d}" for i in range(len(n))]
    write_kaldi_ark_scp({k: f[i, :n[i]] for i, k in enumerate(keys)},
                        ws / "feats.ark", ws / "feats.scp")
    scp = open_feats_scp(ws / "feats.scp")
    mats = [scp[k] for k in keys]
    out = np.zeros((len(mats), max(len(m) for m in mats), cfg.n_mels),
                   np.float32)
    for i, m in enumerate(mats):
        out[i, :len(m)] = m
    return out, np.array([len(m) for m in mats], np.int32)


def phase_asr_variants(torch, np, smi):
    """InterCTC (conformer and transformer), CTC-only and attention-only
    conformers, remat on two conv routes, and the feats, sliding_window and
    fused frontends, each with its exact kernel launches."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.configs import bench_config
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
    from espnet_tpu_torch.models.asr import feature_dim
    from espnet_tpu_torch.models.subsampling import _conv_out_len
    from espnet_tpu_torch.ops.launches import counts as launch_counts

    bf16 = torch.bfloat16
    # InterCTC at layer 6: the CTC pair once more a step
    inter_step = {**CONFORMER[1], "ctc_alphas": 2, "ctc_gamma": 2}
    name = "conformer_interctc"
    cfg = bench_config(bf16, **INTERCTC)
    phase_train_parity(torch, np, cfg, tag=f"train-parity[{name}]")
    counts, _, _ = phase_train(
        torch, np, cfg, tag=f"train[{name}]",
        need_stats=("loss_interctc_layer6", "loss_interctc"))
    check_case_launches(name, "3 train steps", counts, inter_step, 3)

    name = "transformer_interctc"
    cfg = bench_config(bf16, "transformer", **INTERCTC)
    phase_train_parity(torch, np, cfg, tag=f"train-parity[{name}]")
    counts, _, _ = phase_train(
        torch, np, cfg, batch_size=VARIANT_BATCH, steps=2,
        tag=f"train[{name}]",
        need_stats=("loss_interctc_layer6", "loss_interctc"))
    check_case_launches(name, "2 train steps", counts,
                        {**CONFIGS["transformer"][1], "ctc_alphas": 2,
                         "ctc_gamma": 2}, 2)

    speech, lengths = requests(np)
    name = "conformer_ctc_only"
    cfg = bench_config(bf16, ctc_weight=1.0)
    model = variant_model(torch, cfg)
    if model.decoder is not None or any(
            n.startswith("decoder.") for n in model.state_dict()):
        raise AssertionError(f"{name}: the model has decoder params")
    try:
        Speech2Text(model)
    except ValueError as e:
        log(name, f"Speech2Text refuses: {e}")
    else:
        raise AssertionError(f"{name}: Speech2Text took a CTC-only model")
    model = model.cuda().eval()
    reset_counts()
    with torch.no_grad():
        enc, olens = model.encode(torch.from_numpy(speech).cuda(),
                                  torch.from_numpy(lengths).cuda())
        hyps = ctc_greedy_decode(model.ctc_log_probs(enc), olens)
    counts = launch_counts()
    check_case_launches(name, "one encode", counts, CONFORMER[0], 1)
    if len(hyps) != len(lengths) or not all(
            0 < i < cfg.vocab_size for h in hyps for i in h):
        raise AssertionError(f"{name}: greedy CTC output out of range")
    log(name, f"ctc_greedy_decode on the {len(lengths)} requests: "
        f"{[len(h) for h in hyps]} tokens; launches exact")
    del model, enc
    counts, _, _ = phase_train(torch, np, cfg, tag=f"train[{name}]",
                               need_stats=("loss_ctc", "ctc_infeasible"))
    check_case_launches(name, "3 train steps", counts, CONFORMER[1], 3)

    name = "conformer_att_only"
    cfg = bench_config(bf16, ctc_weight=0.0)
    model = variant_model(torch, cfg)
    if model.ctc_head is not None or any(
            n.startswith("ctc_head.") for n in model.state_dict()):
        raise AssertionError(f"{name}: the model has ctc_head params")
    s2t = Speech2Text(model, beam_size=10, ctc_weight=0.0,
                      max_steps=40)
    reset_counts()
    t = time.perf_counter()
    results = s2t(speech, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts()
    check_case_launches(name, "serving", counts, CONFORMER[0], 1)
    if len(results) != len(lengths) or not all(
            np.isfinite(r.score) for r in results):
        raise AssertionError(f"{name}: bad decode results")
    log(name, f"Speech2Text ctc_weight 0, beam 10, the {len(lengths)} "
        f"requests (first call, with warm-up): wall {wall:.3f}s; no CTC "
        f"launch [{smi}]")
    del s2t, model
    counts, _, _ = phase_train(
        torch, np, cfg, batch_size=VARIANT_BATCH, steps=2,
        tag=f"train[{name}]", need_stats=("loss_att", "acc"))
    check_case_launches(name, "2 train steps", counts, NO_CTC, 2)

    name = "conformer_remat"
    for route, options, extra in (
            ("plain", {}, {}),
            ("fused_conv", {"fused_conv": True},
             {"conv_module": 2 * L, "conv_module_bwd": L})):
        tag = f"{name}[{route}]"
        cfg = bench_config(bf16)
        check_remat_fp32(torch, np, cfg, options, tag)
        numbers = {}
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat_encoder=remat)
            counts, step_s, peak = phase_train(
                torch, np, c, tag=f"train[{tag} remat {remat}]",
                options=options)
            per = dict(REMAT_STEP if remat else CONFORMER[1])
            if extra:
                per.update({k: (v if remat else L) for k, v in
                            extra.items()})
            check_case_launches(tag, "3 train steps", counts, per, 3)
            numbers[remat] = (step_s, peak)
        (s0, p0), (s1, p1) = numbers[False], numbers[True]
        log(tag, f"bf16 B={TRAIN_BATCH} x {TRAIN_SECONDS} s: peak memory "
            f"{p1:.2f} GiB with remat vs {p0:.2f} without "
            f"({1 - p1 / p0:.1%} less); {s1 * 1e3:.1f} vs {s0 * 1e3:.1f} "
            f"ms/step ({s1 / s0 - 1:+.1%}) [{smi}]")

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_variants_"))
    try:
        for name, (overrides, width) in FRONTENDS.items():
            cfg = bench_config(bf16, **overrides)
            model = variant_model(torch, cfg)
            got = model.encoder.embed.out.in_features
            want = cfg.d_model * _conv_out_len(_conv_out_len(width, 3, 2),
                                               3, 2)
            if feature_dim(cfg) != width or got != want:
                raise AssertionError(f"{name}: encoder input width "
                                     f"{feature_dim(cfg)} ({got})")
            del model
            batch = train_batch(np, VARIANT_BATCH,
                                [TRAIN_SECONDS] * VARIANT_BATCH,
                                TRAIN_LABELS, cfg.vocab_size, 0)
            inputs = None
            if cfg.input_type == "feats":
                inputs = feats_inputs(torch, np, cfg, speech, lengths, ws)
                batch["speech"], batch["speech_lengths"] = feats_inputs(
                    torch, np, cfg, batch["speech"],
                    batch["speech_lengths"], ws)
            log(name, f"frontend {cfg.input_type}: encoder input width "
                f"{width}; train input {batch['speech'].shape}")
            counts = phase_serve(torch, np, cfg, tag=f"serve[{name}]",
                                 inputs=inputs)
            check_case_launches(name, "one encode", counts, CONFORMER[0], 1)
            counts, _, _ = phase_train(
                torch, np, cfg, batch_size=VARIANT_BATCH, steps=2,
                tag=f"train[{name}]", batch=batch)
            check_case_launches(name, "2 train steps", counts,
                                CONFORMER[1], 2)
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# the recipe phase: the north-star config through bin.run, as a user runs it
RECIPE_OVERRIDES = {
    "--recipe.local_data": "synth",
    # 16 utterances: the tts and gan phases took the time 64 needed
    "--recipe.synth_utts": "16",
    # no LibriSpeech and no `tokenizers` on the card (as in the cli phase)
    "--recipe.token_type": "char",
    "--recipe.test_sets": "test_clean",
    "--recipe.stop_stage": "12",
}
# appended to the recipe's asr_args: 4 encoder and 2 decoder layers of the
# conf's widths (its pack stage deflated four 187 MB params files at 12
# and 6); the launch counts follow the layers
RECIPE_DEPTH = ("--model.num_encoder_layers", "4",
                "--model.num_decoder_layers", "2")


def recipe_micro_batches(np, ds, batches, accum):
    """Two micro-batches of the recipe's training (make_train_step's split
    of a batch into consecutive rows, as in `cli_expected`), collated from
    its own data dir at the batch's padded shapes: the shortest, and the
    one whose speech lengths spread the most."""
    from espnet_tpu_torch.data.dataset import collate
    from espnet_tpu_torch.data.sampler import Batch

    lengths = ds.speech_lengths()
    micro = []
    for b in batches:
        n = max(1, min(accum, len(b.keys)))
        while len(b.keys) % n:
            n -= 1
        k = len(b.keys) // n
        for i in range(0, len(b.keys), k):
            keys = b.keys[i:i + k]
            spread = max(lengths[u] for u in keys) - min(lengths[u]
                                                         for u in keys)
            micro.append((b.pad_shapes["speech"], -spread,
                          Batch(keys, b.pad_shapes)))
    shortest = min(micro, key=lambda m: m[:2])[2]
    ragged = min(micro, key=lambda m: (m[1], m[0]))[2]
    out = []
    for mb in (shortest, ragged):
        c = collate(ds, mb)
        out.append({"speech": c["speech"].astype(np.float32),
                    "speech_lengths": c["speech_lengths"],
                    "text": c["text"], "text_lengths": c["text_lengths"]})
    return out


def check_recipe_kernels(torch, np, cfg, batch):
    """The kernels of the recipe's path against their plain versions at the
    shapes its training gives them (utterances of about a second: T' below
    one tile): a float32 train step of the recipe's model (`cfg`, random
    weights) on one of its micro-batches with kernels and plain, then at
    that micro-batch's (B, T') and lengths, in float32 and bfloat16, the
    rel-pos attention forward and backward and the pre-norm FFN at
    M = B x T', and the CTC pair on its labels."""
    import dataclasses

    from espnet_tpu_torch.models.asr import ASRModel
    from espnet_tpu_torch.ops import ctc as tctc
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    phase_train_parity(torch, np, cfg, tag="train-parity[recipe]",
                       batch=batch)
    if cfg.num_heads != 4 or cfg.d_model != 4 * 64:
        raise AssertionError(f"recipe: {cfg.num_heads} heads of "
                             f"{cfg.d_model // cfg.num_heads}, relpos_case "
                             f"builds 4 of 64")
    model = ASRModel(dataclasses.replace(cfg, dtype=torch.float32)).cuda()
    with torch.no_grad():
        enc, olens = model.eval().encode(
            torch.from_numpy(batch["speech"]).cuda(),
            torch.from_numpy(batch["speech_lengths"]).cuda())
    b, tp = enc.shape[:2]
    lengths = [int(n) for n in olens]
    del model, enc
    label = f"recipe B={b} H=4 T={tp} D=64 lengths {lengths}"
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        es = 4 if dtype == torch.float32 else 2
        args, flops, nbytes = relpos_case(torch, b, tp, dtype, lengths, 31)
        with torch.no_grad():
            check_kernel(torch, "relpos_attention", relpos_attention,
                         relpos_attention_plain, args, flops, nbytes, dn,
                         label, iters=10)
        gout = torch.randn(b, 4, tp, 64, generator=torch.Generator()
                           .manual_seed(32)).to("cuda", dtype)
        check_grads(
            torch, "relpos_attention_bwd", dn, label, relpos_attention,
            relpos_attention_plain, args, 6, gout, 16.0 * b * 4 * tp * tp * 64,
            (7 * b * 4 * tp * 64 + 2 * 4 * (2 * tp - 1) * 64) * es + b * tp * 4
            + b * 4 * tp * 12)
    check_ffn_rows(torch, cfg, b * tp, f"recipe M={b}x{tp}")
    rng = np.random.RandomState(33)
    logits = torch.from_numpy(rng.randn(b, tp, cfg.vocab_size).astype(
        np.float32)).cuda()
    # as the loss calls the pair (ops/ctc.py _CTCFromLogits)
    labels = torch.from_numpy(batch["text"]).cuda().long()
    lab_lens = torch.from_numpy(batch["text_lengths"]).cuda().long()
    ext = tctc.extended_labels(labels)
    emit = tctc._emissions(logits, ext, torch.logsumexp(logits, -1))
    check_ctc_pair(torch, emit, tctc.transition_mask(ext), olens.long(),
                   lab_lens, f"recipe B={b} T={tp} S={ext.shape[1]} labels "
                   f"{batch['text_lengths'].tolist()}")


def recipe_call(ws, argv, env):
    """Run bin.run in a subprocess from the repository root; returns its
    log (stderr)."""
    from pathlib import Path

    cmd = [sys.executable, "-m", "espnet_tpu_torch.bin.run"] + argv
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=600)
    with (ws / "run.log").open("a") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-8000:], flush=True)
        raise AssertionError(f"recipe: bin.run exited {proc.returncode}")
    return proc.stderr


def phase_recipe(torch, np, smi):
    """`python -m espnet_tpu_torch.bin.run --config <north-star>` with the
    printed overrides: every stage's marker and files, the kernel launches
    of training and decoding, and a second call that skips every stage."""
    import os
    import re
    import shlex
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.ops.launches import LAUNCH_LOG_ENV
    from espnet_tpu_torch.tasks.abs_task import pop_device
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.utils.config import load_yaml

    conf_path = Path(__file__).resolve().parent / CLI_CONF
    conf = load_yaml(conf_path)["recipe"]
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_recipe_"))
    try:
        exp, data = ws / "exp", ws / "data"
        overrides = dict(RECIPE_OVERRIDES)
        overrides["--recipe.expdir"] = str(exp)
        overrides["--recipe.datadir"] = str(data)
        overrides["--recipe.asr_args"] = shlex.join(
            cli_argv(conf["asr_args"]) + list(RECIPE_DEPTH))
        argv = ["--config", str(conf_path)]
        for flag, value in overrides.items():
            log("recipe", f"set {flag} {value}")
            argv += [flag, value]
        env = dict(os.environ, **{LAUNCH_LOG_ENV: str(ws / "launches.jsonl")})
        t = time.perf_counter()
        out = recipe_call(ws, argv, env)
        wall = time.perf_counter() - t
        walls = re.findall(r"stage (\d+) \((.+?)\) done in ([\d.]+)s", out)
        for n, title, sec in walls:
            log("recipe", f"stage {n:>2} ({title}): {float(sec):.2f}s "
                f"[{smi}]")
        log("recipe", f"stages 1-12 in {wall:.1f}s (bin.run's wall)")
        if sorted(int(n) for n, _, _ in walls) != list(range(1, 13)):
            raise AssertionError(f"recipe: stages run {walls}")
        for n in range(1, 13):
            if not (exp / f".stage{n}.done").exists():
                raise AssertionError(f"recipe: no .stage{n}.done")
        asr = exp / "asr"
        for f in (exp / "tokens" / "tokens.txt",
                  asr / "stats" / "feats_stats.npz", asr / "config.yaml",
                  asr / "ep1.params.msgpack", asr / "ep2.params.msgpack",
                  asr / "valid.acc.ave.params.msgpack", asr / "checkpoint.pt",
                  exp / "decode_test_clean" / "text",
                  exp / "decode_test_clean" / "score_wer.txt",
                  exp / "RESULTS.md", exp / "results.json",
                  exp / "packed_model.zip"):
            if not f.exists():
                raise AssertionError(f"recipe: {f.relative_to(ws)} missing")
        if "device" in (asr / "config.yaml").read_text().replace(
                "device parallelism", ""):
            raise AssertionError("recipe: --device went into config.yaml")

        # the launches of each CLI the recipe ran, against the batches the
        # task and the decoder build from the recipe's data dirs
        calls = [json.loads(ln) for ln in
                 (ws / "launches.jsonl").read_text().splitlines()]
        if [c["cli"] for c in calls] != ["asr_train", "asr_train",
                                         "asr_inference"]:
            raise AssertionError(f"recipe: CLI calls {calls}")
        cfg = ASRTask.parse_config(pop_device(calls[1]["argv"])[1])
        run, dcfg, mcfg = cfg["run"], cfg["data"], cfg["model"]
        tokens = ASRTask.build_tokenizer(dcfg, asr)
        conv = ASRTask.build_token_list(dcfg, asr, tokens)
        ds_train = ASRTask.build_dataset(dcfg, dcfg.train_dir, tokens, conv)
        ds_valid = ASRTask.build_dataset(dcfg, dcfg.valid_dir, tokens, conv,
                                         train=False)
        per_epoch, micro = cli_expected(
            cli_batches(ds_train, dcfg, dcfg.batch_size),
            cli_batches(ds_valid, dcfg, dcfg.batch_size), run.accum_grad,
            mcfg.num_encoder_layers)
        check_launches("the recipe's collect-stats", calls[0]["launches"],
                       expected_counts({}, 1))
        check_launches("the recipe's training", calls[1]["launches"],
                       {k: run.max_epoch * v for k, v in per_epoch.items()})
        dargs = shlex.split(conf["decode_args"])
        ds_test = ASRTask.build_dataset(dcfg, data / "test_clean", tokens,
                                        conv, train=False)
        n_dec = len(cli_batches(
            ds_test, dcfg, int(dargs[dargs.index("--batch_size") + 1])))
        check_launches("the recipe's decoding", calls[2]["launches"],
                       expected_counts({
                           "relpos_attention": mcfg.num_encoder_layers,
                           "prenorm_ffn": 2 * mcfg.num_encoder_layers},
                           n_dec))
        log("recipe", f"{len(ds_train)} training utterances (speed "
            f"perturbed x3), {micro} micro-batches an epoch, "
            f"{run.max_epoch} epochs; {len(ds_test)} test utterances in "
            f"{n_dec} decode batches; launches exact")
        rcfg = ASRTask.build_model(mcfg, len(conv)).config
        for batch in recipe_micro_batches(np, ds_train, cli_batches(
                ds_train, dcfg, dcfg.batch_size), run.accum_grad):
            check_recipe_kernels(torch, np, rcfg, batch)
        rtf = (exp / "decode_test_clean" / "rtf.txt").read_text().strip()
        wer = (exp / "decode_test_clean" / "score_wer.txt").read_text()
        log("recipe", f"decode test_clean: {rtf} [{smi}]")
        log("recipe", f"WER after {run.max_epoch} epochs (no gate): "
            f"{wer.strip().splitlines()[-1] if wer.strip() else wer}")

        # a second call skips every stage and runs no CLI
        stamp = (asr / "ep2.params.msgpack").stat().st_mtime_ns
        t = time.perf_counter()
        out = recipe_call(ws, argv, env)
        skipped = re.findall(r"stage (\d+) \(.+?\): already done, skipping",
                             out)
        calls2 = (ws / "launches.jsonl").read_text().splitlines()
        if (sorted(int(n) for n in skipped) != list(range(1, 13))
                or len(calls2) != len(calls)
                or (asr / "ep2.params.msgpack").stat().st_mtime_ns != stamp):
            raise AssertionError("recipe: the second call did not skip every "
                                 "stage")
        log("recipe", f"second call skipped stages 1-12 in "
            f"{time.perf_counter() - t:.1f}s")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# the trained-exp phase: the JAX-trained synth_hard conformer (6 x 128,
# kernel 15, FFN 512, a 2-layer decoder, global MVN, char tokens) decoded by
# the port with the recipe's decode_args, which wrote exp/decode_test
# (tools/synth_headtohead.sh), and its JAX resume state resumed
SYNTH = "egs_work/synth_hard"
SYNTH_EXP = f"{SYNTH}/exp/asr"
SYNTH_PARAMS = f"{SYNTH_EXP}/valid.acc.ave.params.msgpack"
SYNTH_FILES = (SYNTH_PARAMS, f"{SYNTH_EXP}/config.yaml",
               f"{SYNTH_EXP}/stats/feats_stats.npz",
               f"{SYNTH_EXP}/checkpoint.msgpack",
               f"{SYNTH_EXP}/checkpoint.meta.json",
               f"{SYNTH}/exp/tokens/tokens.txt",
               f"{SYNTH}/exp/decode_test/text", f"{SYNTH}/data/test/wav.scp",
               f"{SYNTH}/data/test/text")
SYNTH_DECODE = ["--beam_size", "5", "--ctc_weight", "0.3", "--max_steps",
                "60", "--batch_size", "30"]
SYNTH_RESUME_UTTS = 4


def synth_decode(np, ws, dtype_name, smi):
    """The 300 test utterances through bin.asr_inference in `dtype_name`:
    text against JAX's decode_test/text, WER 0.0, the exact launches."""
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_inference
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.tasks.asr import ASRTask

    exp = ws / f"exp_{dtype_name}"
    (exp / "stats").mkdir(parents=True)
    conf = Path(SYNTH_EXP, "config.yaml").read_text()
    if conf.count("  dtype: float32\n") != 1:
        raise AssertionError("synth_hard config.yaml: no single model dtype")
    (exp / "config.yaml").write_text(
        conf.replace("  dtype: float32\n", f"  dtype: {dtype_name}\n"))
    (exp / "stats" / "feats_stats.npz").write_bytes(
        Path(SYNTH_EXP, "stats", "feats_stats.npz").read_bytes())
    out = ws / f"decode_{dtype_name}"
    wrappers = reset_counts()
    asr_inference.main(["--exp_dir", str(exp), "--data_dir",
                        f"{SYNTH}/data/test", "--output_dir", str(out),
                        "--params", SYNTH_PARAMS, *SYNTH_DECODE,
                        "--device", "cuda"])
    counts = {name: fn.launches for name, fn in wrappers.items()}
    ref = read_2column_text(f"{SYNTH}/exp/decode_test/text")
    hyp = read_2column_text(out / "text")
    bad = [k for k in ref if hyp.get(k) != ref[k]]
    if bad or len(hyp) != len(ref):
        raise AssertionError(
            f"trained-exp {dtype_name}: {len(bad)} of {len(ref)} texts differ "
            f"from JAX's decode_test/text, e.g. "
            f"{[(k, hyp.get(k), ref[k]) for k in bad[:3]]}")
    wer = (out / "score_wer.txt").read_text().strip()
    if "| Err 0.0 |" not in wer:
        raise AssertionError(f"trained-exp {dtype_name}: WER {wer}")
    cfg = ASRTask.load_config(exp)
    tok = ASRTask.build_tokenizer(cfg["data"], exp)
    conv = ASRTask.build_token_list(cfg["data"], exp, tok)
    ds = ASRTask.build_dataset(cfg["data"], f"{SYNTH}/data/test", tok, conv,
                               train=False)
    n_batches = len(cli_batches(ds, cfg["data"], 30))
    layers = cfg["model"].num_encoder_layers
    check_launches(f"trained-exp {dtype_name} decoding", counts,
                   expected_counts({"relpos_attention": layers,
                                    "prenorm_ffn": 2 * layers}, n_batches))
    log("trained-exp", f"{dtype_name}: {len(hyp)} texts equal to JAX's "
        f"decode_test/text, {wer}; {(out / 'rtf.txt').read_text().strip()} "
        f"[{smi}]; launches exact ({n_batches} batches: rel-pos attention "
        f"head dim 32, pre-norm FFN D 128 F 512)")


def synth_resume(np, ws):
    """asr_train --run.resume on a copy of the JAX resume state (epoch 30):
    one epoch-31 step on a few test utterances."""
    import shutil
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_train
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.train.msgpack_io import flatten, load_tree

    exp, data = ws / "resume", ws / "data"
    (exp / "stats").mkdir(parents=True)
    for name in ("config.yaml", "checkpoint.msgpack", "checkpoint.meta.json",
                 "stats/feats_stats.npz"):
        shutil.copy(Path(SYNTH_EXP, name), exp / name)
    keys = sorted(read_2column_text(f"{SYNTH}/data/test/wav.scp"))
    keys = keys[:SYNTH_RESUME_UTTS]
    data.mkdir()
    for f in ("wav.scp", "text"):
        rows = read_2column_text(f"{SYNTH}/data/test/{f}")
        write_2column_text(data / f, {k: rows[k] for k in keys})
    argv = ["--config", str(exp / "config.yaml"), "--run.output_dir",
            str(exp), "--run.max_epoch", "31", "--run.resume", "true",
            "--data.train_dir", str(data), "--data.valid_dir", str(data),
            "--data.batch_size", str(SYNTH_RESUME_UTTS), "--device", "cuda"]
    wrappers = reset_counts()
    t = time.perf_counter()
    _, trainer, _, _, _ = asr_train.main(argv)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    steps = [st for e, st in trainer.step_log if e == 31]
    if sorted(trainer.epoch_seconds) != [31] or not steps:
        raise AssertionError(f"trained-exp resume: epochs "
                             f"{sorted(trainer.epoch_seconds)}, steps {steps}")
    for st in steps:
        if not (np.isfinite(st["loss"]) and st["skipped"] == 0.0):
            raise AssertionError(f"trained-exp resume: step {st}")
    before = flatten(load_tree(Path(SYNTH_EXP, "checkpoint.msgpack"))
                     ["params"])
    after = flatten(load_tree(exp / "ep31.params.msgpack"))
    moved = max(float(np.abs(after[k] - v).max()) for k, v in before.items())
    if not moved > 0.0:
        raise AssertionError("trained-exp resume: parameters did not move")
    cfg = ASRTask.parse_config(argv[:-2])
    tok = ASRTask.build_tokenizer(cfg["data"], exp)
    conv = ASRTask.build_token_list(cfg["data"], exp, tok)
    ds = ASRTask.build_dataset(cfg["data"], data, tok, conv)
    batches = cli_batches(ds, cfg["data"], SYNTH_RESUME_UTTS)
    want, _ = cli_expected(batches, batches, 1,
                           cfg["model"].num_encoder_layers)
    check_launches("trained-exp resume", counts, want)
    log("trained-exp", f"resumed JAX's checkpoint.msgpack (epoch 30): "
        f"{len(steps)} epoch-31 step(s), loss "
        f"{[round(st['loss'], 4) for st in steps]}, max parameter move "
        f"{moved:.3e}, {wall:.1f}s with validation; launches exact")


def phase_trained_exp(torch, np, smi):
    """The JAX-trained synth_hard experiment: its 300 test utterances
    decoded by the port in float32 and bf16, and its resume state resumed
    for one step."""
    import shutil
    import tempfile
    from pathlib import Path

    missing = [f for f in SYNTH_FILES if not Path(f).exists()]
    if missing:
        raise FileNotFoundError(f"trained-exp: the checkout lacks {missing}")
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_trained_"))
    try:
        for dtype_name in ("float32", "bfloat16"):
            synth_decode(np, ws, dtype_name, smi)
        synth_resume(np, ws)
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# the streaming phase: the streaming_conformer configuration (the bench
# conformer's widths, contextual-block encoder 40 / 16 / 16) at full width
STREAM_CHUNK = 1600      # samples a simulated chunk (0.1 s)
# beam 4 and a 32-label budget, not the offline serve's 10 and the
# engines' default 64: the two engines' beam walls (70-85 s at 10 or 4 with
# 64 labels) paid for the gan phase
STREAM_BEAM = 4
STREAM_MAX_STEPS = 32
BLOCK_ROWS = 42          # block 40 + 2 context slots, one utterance


def streaming_offline(torch, model, wave, search):
    """The offline result the streaming engines must give: CTC greedy or
    the beam search over the whole utterance's encoder output."""
    from espnet_tpu_torch.decode.beam_search import batched_beam_search
    from espnet_tpu_torch.decode.ctc_greedy import collapse_ctc
    from espnet_tpu_torch.decode.streaming_inference import beam_config

    c = model.config
    with torch.no_grad():
        enc, lens = model.encode(
            torch.from_numpy(wave[None]).cuda(),
            torch.tensor([len(wave)], device="cuda"))
        lp = model.ctc_log_probs(enc)
        if search == "greedy":
            return collapse_ctc(lp[0, :int(lens[0])].argmax(-1).tolist())
        w = STREAM_BEAM
        mem, mem_lens = enc.repeat_interleave(w, 0), lens.repeat_interleave(w)
        yseq, ylen, _ = batched_beam_search(
            beam_config(w, 0.3, 0.0, c.blank_id), c.sos_id, c.eos_id,
            c.vocab_size, lens,
            lambda tok, pos, cache: model.decoder_score_step(
                tok, pos, mem, mem_lens, cache),
            model.decoder_init_cache(w, STREAM_MAX_STEPS + 1, mem,
                                     mem_lens),
            ctc_log_probs=lp, max_steps=STREAM_MAX_STEPS)
        return yseq[0, 0, :int(ylen[0, 0])].tolist()


def stream_one(torch, rec, wave):
    """Feed `wave` in STREAM_CHUNK chunks; returns (ids, wall seconds, the
    ms of each quantum step of the device engine, blocks run)."""
    times, blocks = [], []
    advance, run_block = getattr(rec, "_advance", None), rec._run_block

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        advance(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)

    def counted(*a, **k):
        blocks.append(1)
        return run_block(*a, **k)

    rec._run_block = counted
    if advance is not None:
        rec._advance = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(0, len(wave), STREAM_CHUNK):
            out = rec(wave[i:i + STREAM_CHUNK],
                      is_final=i + STREAM_CHUNK >= len(wave))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        del rec._run_block
        if advance is not None:
            del rec._advance
    return out["token_ids"], wall, times, len(blocks)


def streaming_engines(torch, np, model, smi):
    """(c): both engines, greedy and beam, on the requests: greedy equal to
    offline CTC greedy and the two engines' beam results equal (beam against
    the offline search is counted: the online search commits steps on
    partial input, which the offline search need not take), ms per quantum,
    RTF, fused_ffn launches a block. Returns the greedy ids by request."""
    from espnet_tpu_torch.decode.streaming_device import \
        DeviceStreamingRecognizer
    from espnet_tpu_torch.decode.streaming_inference import \
        Speech2TextStreaming

    speech, lengths = requests(np)
    waves = [speech[i, :n] for i, n in enumerate(lengths)]
    ffn = 2 * model.config.num_encoder_layers
    results = {}
    for search in ("greedy", "beam"):
        offline = [streaming_offline(torch, model, w, search) for w in waves]
        for name, engine in (("device", DeviceStreamingRecognizer),
                             ("host", Speech2TextStreaming)):
            rec = engine(model, search=search, beam_size=STREAM_BEAM,
                         max_steps=STREAM_MAX_STEPS, device="cuda")
            stream_one(torch, rec, waves[0])  # warm-up
            walls, quanta, per_block, got = [], [], set(), []
            for w in waves:
                wrappers = reset_counts()
                ids, wall, times, blocks = stream_one(torch, rec, w)
                counts = {k: fn.launches for k, fn in wrappers.items()}
                if counts != expected_counts({"fused_ffn": ffn}, blocks):
                    raise AssertionError(
                        f"streaming {name} {search}: {blocks} blocks "
                        f"launched {counts}")
                per_block.add(counts["fused_ffn"] // max(blocks, 1))
                walls.append(wall)
                quanta += times
                got.append(ids)
            results[search, name] = got
            same = sum(g == o for g, o in zip(got, offline))
            if search == "greedy" and same != len(waves):
                raise AssertionError(f"streaming {name} greedy: {same} of "
                                     f"{len(waves)} requests equal offline")
            audio = float(sum(lengths)) / SAMPLE_RATE
            q = (f"ms a quantum (0.512 s of audio) median "
                 f"{np.median(quanta):.2f}, worst {max(quanta):.2f} over "
                 f"{len(quanta)}; " if quanta else "")
            log("streaming", f"{name} engine, {search}"
                f"{f' {STREAM_BEAM}' if search == 'beam' else ''}, chunks of "
                f"{STREAM_CHUNK}: {same} of {len(waves)} requests equal to "
                f"offline; {q}streaming RTF {sum(walls) / audio:.4f} "
                f"({sum(walls):.2f}s for {audio:.0f}s) [{smi}]; fused_ffn "
                f"{sorted(per_block)} launches a block")
        if results[search, "device"] != results[search, "host"]:
            raise AssertionError(f"streaming {search}: the engines differ")
    return dict(enumerate(results["greedy", "device"]))


def streaming_cli(torch, np, model, greedy):
    """(f): bin.asr_inference_streaming in both engines on an experiment
    directory that the port's CheckpointManager wrote from `model`."""
    import dataclasses
    import json
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_inference_streaming
    from espnet_tpu_torch.data.fileio import write_2column_text, write_wav
    from espnet_tpu_torch.tasks.abs_task import OptimConfig, RunConfig
    from espnet_tpu_torch.tasks.asr import (ASRDataConfig, ASRModelSection,
                                            ASRTask)
    from espnet_tpu_torch.train.checkpoint import CheckpointManager

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    try:
        c = model.config
        exp, data = ws / "exp", ws / "test"
        fill = [f"x{i}" for i in range(c.vocab_size - 30)]
        tokens = (["<blank>", "<unk>", "<space>"]
                  + [chr(ord("a") + i) for i in range(26)] + fill
                  + ["<sos/eos>"])
        exp.mkdir()
        (exp / "tokens.txt").write_text("\n".join(tokens) + "\n")
        fields = {f.name for f in dataclasses.fields(ASRModelSection)}
        section = ASRModelSection(**{
            k: v for k, v in dataclasses.asdict(c).items()
            if k in fields and k not in ("vocab_size", "dtype")})
        ASRTask.dump_config({
            "run": RunConfig(output_dir=str(exp)), "optim": OptimConfig(),
            "data": ASRDataConfig(token_list=str(exp / "tokens.txt")),
            "model": section}, exp)
        CheckpointManager(exp).save_epoch_params(model, 1)
        speech, lengths = requests(np)
        wavs = {}
        for i, n in enumerate(lengths):
            key = f"req{i}"
            write_wav(data / "wav" / f"{key}.wav", speech[i, :n], SAMPLE_RATE)
            wavs[key] = str(data / "wav" / f"{key}.wav")
        write_2column_text(data / "wav.scp", wavs)
        write_2column_text(data / "text", {k: "a b" for k in wavs})
        texts = {}
        for engine in ("device", "host"):
            out = ws / f"decode_{engine}"
            asr_inference_streaming.main([
                "--exp_dir", str(exp), "--data_dir", str(data),
                "--output_dir", str(out), "--engine", engine,
                "--sim_chunk_length", str(STREAM_CHUNK), "--device", "cuda"])
            rows = [json.loads(ln) for ln in
                    (out / "nbest.jsonl").read_text().splitlines()]
            got = {int(r["key"][3:]): r["token_ids"] for r in rows}
            if got != greedy or not (out / "score_wer.txt").exists():
                raise AssertionError(f"streaming CLI {engine}: ids differ "
                                     "from the engines' greedy ids")
            texts[engine] = (out / "text").read_text()
        if texts["device"] != texts["host"]:
            raise AssertionError("streaming CLI: the engines' texts differ")
        log("streaming", f"bin.asr_inference_streaming, both engines, on an "
            f"experiment written by CheckpointManager: {len(rows)} requests,"
            f" the engines' greedy ids")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def phase_streaming(torch, np, smi):
    """The streaming path at full width: (a) the encoder's two modes,
    (b) fused_ffn at one block's rows, (c) both engines, (d) a float32
    train step with kernels against plain, (e) 3 bf16 bench steps, (f) the
    streaming CLI."""
    from espnet_tpu_torch.configs import bench_config
    from espnet_tpu_torch.models.asr import ASRModel, init_random_
    from espnet_tpu_torch.models.streaming import _block_geometry
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain

    cfg = bench_config(torch.float32, "streaming_conformer")
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    e = model.encoder
    speech, lengths = requests(np)
    sp = torch.from_numpy(speech).cuda()
    ln = torch.from_numpy(lengths).cuda()
    # (a) all blocks in parallel against block after block
    outs = {}
    with torch.no_grad():
        feats, flens = model.frontend(sp, ln)
        for use in (True, False):
            model.set_use_kernels(use)
            wrappers = reset_counts()
            par, olens = e(feats, flens)
            n_par = {k: fn.launches for k, fn in wrappers.items()}
            wrappers = reset_counts()
            blk, _ = e.forward_blockwise(feats, flens)
            n_blk = {k: fn.launches for k, fn in wrappers.items()}
            valid = (torch.arange(par.shape[1], device="cuda")[None, :]
                     < olens[:, None])[:, :, None]
            dev = float(((par - blk).abs() * valid).max())
            label = "kernels" if use else "plain"
            log("streaming", f"(a) forward vs forward_blockwise, float32, "
                f"{label}, B={par.shape[0]} T'={par.shape[1]}: max |dev| "
                f"{dev:.3e} (limit 1e-4)")
            if dev > 1e-4 or not torch.isfinite(par).all():
                raise AssertionError(f"streaming: the encoder's modes differ "
                                     f"({label}) by {dev:.3e}")
            nblk = _block_geometry(par.shape[1], e.block_size, e.hop_size,
                                   e.look_ahead)[0]
            ffn = 2 * cfg.num_encoder_layers
            want = (({"fused_ffn": ffn}, {"fused_ffn": ffn * nblk}) if use
                    else ({}, {}))
            if (n_par, n_blk) != tuple(expected_counts(w, 1) for w in want):
                raise AssertionError(f"streaming (a) {label}: launches "
                                     f"{n_par}, {n_blk}")
            outs[use] = (par, valid)
        model.set_use_kernels(True)
    (par, valid), (plain, _) = outs[True], outs[False]
    dev = float(((par - plain).abs() * valid).max())
    log("streaming", f"(a) encoder output, kernels vs plain: max |dev| "
        f"{dev:.3e} (limit {ENCODER_FP32_TOL}); launches exact (fused_ffn "
        f"{ffn} a forward, {ffn} x {nblk} blocks blockwise)")
    if dev > ENCODER_FP32_TOL:
        raise AssertionError(f"streaming encoder, kernels vs plain {dev:.3e}")
    # (b) fused_ffn at one block's rows (below one 64-row tile)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args, (flops, nbytes), _ = fused_ffn_case(torch, BLOCK_ROWS, dtype,
                                                  31, d=256, f=2048)
        with torch.no_grad():
            check_kernel(torch, "fused_ffn", fused_ffn, fused_ffn_plain,
                         args, flops, nbytes, dn,
                         f"streaming block M={BLOCK_ROWS} D=256 F=2048 swish",
                         {"activation": "swish"})
    # (c) the engines; (f) the CLI on the same weights
    greedy = streaming_engines(torch, np, model, smi)
    streaming_cli(torch, np, model, greedy)
    # (d) float32 train step, kernels vs plain; (e) the bench's steps
    phase_train_parity(torch, np, cfg, tag="train-parity[streaming]")
    steps = TRAIN_TIMED_STEPS
    launches, step_s, peak = phase_train(
        torch, np, bench_config(torch.bfloat16, "streaming_conformer"),
        tag="train[streaming]", steps=steps)
    ffn = 2 * cfg.num_encoder_layers
    want = expected_counts({"fused_ffn": ffn, "fused_ffn_bwd": ffn, **CTC},
                           steps)
    if launches != want:
        raise AssertionError(f"streaming: {steps} train steps launched "
                             f"{launches}, expected {want}")
    log("streaming", f"(e) {step_s * 1e3:.1f} ms/step, peak {peak:.2f} GiB "
        f"[{smi}]; launches exact")


def transducer_case(torch, np, b, t, u, v, ilens, llens, seed):
    """The lattice inputs of seeded (B, T, U+1, V) logits on the card: the
    float32 log-softmax's blank column and masked label emissions, as the
    loss gathers them; labels padded with the blank past each length."""
    from espnet_tpu_torch.ops import transducer as ttr

    g = torch.Generator(device="cuda").manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, u + 1, v, generator=g,
                                       device="cuda"), -1)
    rng = np.random.RandomState(seed)
    labels = torch.from_numpy(rng.randint(1, v, (b, u))).cuda()
    ilen = torch.tensor(ilens, device="cuda")
    llen = torch.tensor(llens, device="cuda")
    labels[torch.arange(u, device="cuda")[None, :] >= llen[:, None]] = 0
    blank, lab = ttr.lattice_inputs(lp, labels, llen)
    del lp
    return blank, lab, ilen, llen


def check_transducer_pair(torch, blank, lab, ilen, llen, label,
                          plain_iters=2):
    """transducer_alphas and transducer_occupancy against their plain
    versions on one lattice (float32), each timed with CUDA events and by
    its device time, beside the bound and the chain of T+U waves. Returns
    the two kernels' results by name."""
    from espnet_tpu_torch.ops import transducer_lattice as trl

    b, t, u1 = blank.shape
    atol, rtol = RNNT_TOLERANCE
    nodes = float(ilen.clamp(0, t).sum()) * u1  # the walk's nodes
    waves = int(ilen.max()) + u1 - 1
    args = (blank, lab, ilen, llen)

    def how(pairs, atol_, rtol_):
        worst, max_err, finite = 0.0, 0.0, True
        for got, want in pairs:
            finite &= bool(torch.isfinite(got).all())
            err = (got - want).abs()
            max_err = max(max_err, float(err.max()))
            worst = max(worst, float((err - rtol_ * want.abs()).max()))
        return max_err, finite and worst <= atol_, (
            f"max |err| {max_err:.3e} (atol {atol_}, rtol {rtol_})")

    alphas, log_z = trl.transducer_alphas(*args)
    pa, plz = trl.transducer_alphas_plain(*args)
    occ_b, occ_l = trl.transducer_occupancy(*args, alphas, log_z)
    pob, pol = trl.transducer_occupancy_plain(*args, pa, plz)
    torch.cuda.synchronize()
    out = {}
    lengths = b * 16
    for name, pairs, tol, call, plain, ops, nbytes in (
            ("transducer_alphas", ((alphas, pa), (log_z, plz)), (atol, rtol),
             lambda: trl.transducer_alphas(*args),
             lambda: trl.transducer_alphas_plain(*args), RNNT_ALPHA_OPS,
             # blank and lab read, alphas written, lengths, log Z
             (2 * b * t * u1 + b * t * (u1 - 1)) * 4 + lengths + b * 4),
            ("transducer_occupancy", ((occ_b, pob), (occ_l, pol)),
             (RNNT_OCC_ATOL, 0.0),
             lambda: trl.transducer_occupancy(*args, alphas, log_z),
             lambda: trl.transducer_occupancy_plain(*args, alphas, log_z),
             RNNT_OCC_OPS,
             # blank, lab, alphas, log Z read; both occupancies written
             (3 * b * t * u1 + 2 * b * t * (u1 - 1)) * 4 + lengths + b * 4)):
        max_err, ok, text = how(pairs, *tol)
        dev = device_ms(torch, call)
        bound_ms, bound_by = bound(ops * nodes, nbytes, PEAK_FLOPS["float32"])
        out[name] = report(name, label, "float32", text, ok,
                           time_ms(torch, call, 10),
                           time_ms(torch, plain, plain_iters), bound_ms,
                           bound_by, max_err, dev_ms=dev)
        per_wave = "not measured" if dev is None else \
            f"{dev / waves * 1e3:.3f} us a wave"
        log("transducer", f"{name} {label}: the chain is {waves} waves "
            f"(T+U), {per_wave} on the device; bytes and operations bound "
            f"it at {bound_ms * 1e3:.3f} us")
    return out


def transducer_serve(torch, np, cfg, smi, device="cuda"):
    """Greedy and mAES (beam 5, 3 expansions) on the requests, float32:
    the kernel route against the plain encoder route, launches exact
    (device="cpu" with a small config rehearses it where there is no card:
    no launch is then expected)."""
    from espnet_tpu_torch.decode.transducer_inference import \
        Speech2TextTransducer
    from espnet_tpu_torch.models.asr import init_random_

    model = init_random_(build_model(cfg), torch.Generator().manual_seed(0))
    log("transducer", f"model built: "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"compute {cfg.dtype}")
    speech, lengths = requests(np)
    audio = float(sum(REQUEST_SECONDS))
    per_encode = ({"relpos_attention": cfg.num_encoder_layers,
                   "prenorm_ffn": 2 * cfg.num_encoder_layers}
                  if device == "cuda" else {})
    for search, beam in (("greedy", 1), ("maes", 5)):
        s2t = Speech2TextTransducer(model, device=device, beam_size=beam,
                                    max_expansions=3, search=search)
        s2t(speech, lengths)  # warm-up
        sync(torch, device)
        wrappers = reset_counts()
        t = time.perf_counter()
        got = s2t(speech, lengths)
        sync(torch, device)
        wall = time.perf_counter() - t
        counts = {name: fn.launches for name, fn in wrappers.items()}
        if counts != expected_counts(per_encode, 1):
            raise AssertionError(f"transducer {search}: one decode launched "
                                 f"{counts}, expected {per_encode}")
        model.set_use_kernels(False)
        want = s2t(speech, lengths)
        model.set_use_kernels(True)
        worst = max(abs(g.score - w.score) / max(1.0, abs(w.score))
                    for g, w in zip(got, want))
        same = all(g.token_ids == w.token_ids for g, w in zip(got, want))
        log("transducer", f"(b) {search} beam {beam}, {len(got)} requests, "
            f"{audio:.0f} s of audio: wall {wall:.3f}s, RTF "
            f"{wall / audio:.5f} [{smi}]; tokens "
            f"{[len(r.token_ids) for r in got]}, equal to the plain route's "
            f"{same}, scores {[round(r.score, 4) for r in got]} (worst "
            f"relative dev {worst:.2e}, limit {RNNT_SCORE_RTOL}); launches "
            f"exact")
        if not same or worst > RNNT_SCORE_RTOL:
            raise AssertionError(f"transducer {search}: the kernel route's "
                                 "decode differs from the plain route's")
        if not all(np.isfinite(r.score) and all(
                0 <= i < cfg.vocab_size for i in r.token_ids) for r in got):
            raise AssertionError(f"transducer {search}: bad results")


RNNT_CLI_ARGS = (
    "--run.max_epoch 1 --run.log_interval 1 "
    "--run.best_metric valid.loss.min --data.token_type char "
    "--data.batch_size 8 --model.num_encoder_layers 2")
RNNT_CLI_LAYERS = 2


def transducer_cli(torch, np, smi):
    """bin.asr_transducer_train and bin.asr_transducer_inference (greedy,
    mAES) in process (a subprocess's start costs 8-10 s on a busy host),
    each with its launch counts."""
    import importlib
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.tasks.transducer import TransducerTask

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_rnnt_"))
    try:
        generate_corpus(ws / "train", n_utts=24, min_words=4, max_words=10,
                        seed=0)
        generate_corpus(ws / "valid", n_utts=8, min_words=4, max_words=10,
                        seed=1)
        exp = ws / "exp"
        train = RNNT_CLI_ARGS.split() + [
            "--data.train_dir", str(ws / "train"),
            "--data.valid_dir", str(ws / "valid"),
            "--run.output_dir", str(exp)]
        calls = [("asr_transducer_train", train)]
        for search, beam in (("greedy", 1), ("maes", 5)):
            calls.append(("asr_transducer_inference", [
                "--exp_dir", str(exp), "--data_dir", str(ws / "valid"),
                "--output_dir", str(ws / f"decode_{search}"),
                "--beam_size", str(beam), "--search", search,
                "--batch_size", "4"]))
        logged = []
        for cli, argv in calls:
            main = importlib.import_module(f"espnet_tpu_torch.bin.{cli}").main
            _, counts, wall = counted_call(main, argv)
            logged.append({"cli": cli, "argv": argv, "launches": counts})
            log("transducer", f"(d) {cli} {' '.join(argv[-6:])}: "
                f"{wall:.1f}s")
        cfg = TransducerTask.load_config(exp)
        data = cfg["data"]
        tokens = TransducerTask.build_tokenizer(data, exp)
        conv = TransducerTask.build_token_list(data, exp, tokens)
        n_train = len(cli_batches(TransducerTask.build_dataset(
            data, ws / "train", tokens, conv), data, data.batch_size))
        ds_valid = TransducerTask.build_dataset(data, ws / "valid", tokens,
                                                conv, train=False)
        n_valid = len(cli_batches(ds_valid, data, data.batch_size))
        n_dec = len(cli_batches(ds_valid, data, 4))
        n = RNNT_CLI_LAYERS
        want = expected_counts({}, 1)
        want.update({
            "relpos_attention": n * (n_train + n_valid),
            "relpos_attention_bwd": n * n_train,
            "prenorm_ffn": 2 * n * (n_train + n_valid),
            "prenorm_ffn_bwd": 2 * n * n_train,
            "transducer_alphas": n_train + n_valid,
            "transducer_occupancy": n_train})
        check_launches("asr_transducer_train", logged[0]["launches"], want)
        for call in logged[1:]:
            check_launches(f"asr_transducer_inference {call['argv']}",
                           call["launches"], expected_counts(
                               {"relpos_attention": n,
                                "prenorm_ffn": 2 * n}, n_dec))
        for search in ("greedy", "maes"):
            out = ws / f"decode_{search}"
            hyps = (out / "text").read_text().splitlines()
            if len(hyps) != len(ds_valid) or not (
                    out / "score_wer.txt").exists():
                raise AssertionError(f"transducer: decode_{search} files")
            log("transducer", f"(d) {search}: {len(hyps)} utterances, "
                f"{(out / 'rtf.txt').read_text().strip()} [{smi}]")
        log("transducer", f"(d) {n_train} train and {n_valid} validation "
            f"batches, {n_dec} decode batches each search; launches exact")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def phase_transducer(torch, np, smi):
    """The RNN-T at full width: (a) the lattice pair's kernel lines, (b)
    greedy and mAES serving, (c) a float32 train step with kernels against
    plain and 3 bf16 steps, (d) both CLIs. Returns (the train-shape kernel
    results, the 3 timed train steps' launch counts)."""
    from espnet_tpu_torch.configs import transducer_conformer
    from espnet_tpu_torch.models.subsampling import subsampled_length
    from espnet_tpu_torch.ops import transducer_lattice as trl

    t0 = time.perf_counter()
    cfg = transducer_conformer(torch.float32)
    frames = int(TRAIN_SECONDS * SAMPLE_RATE) // cfg.hop_length + 1
    tp = int(subsampled_length(frames, cfg.subsampling_factor))
    # (a) the training shape, then a character-level label count
    b, u = RNNT_BATCH, RNNT_LABELS
    case = transducer_case(torch, np, b, tp, u, cfg.vocab_size, [tp] * b,
                           [u] * b, 21)
    main = check_transducer_pair(
        torch, *case, f"train B={b} T={tp} U={u} V={cfg.vocab_size}")
    rng = np.random.RandomState(22)
    uc = 200
    ilens = [tp] + rng.randint(tp // 3, tp + 1, b - 1).tolist()
    llens = [uc] + rng.randint(uc // 2, uc + 1, b - 1).tolist()
    case = transducer_case(torch, np, b, tp, uc, 64, ilens, llens, 23)
    check_transducer_pair(torch, *case,
                          f"characters B={b} T={tp} U={uc} V=64, ragged")
    del case
    before = trl.transducer_alphas.launches
    try:
        trl.transducer_alphas(torch.zeros(1, 2, 1025, device="cuda"),
                              torch.zeros(1, 2, 1024, device="cuda"),
                              torch.tensor([2], device="cuda"),
                              torch.tensor([1], device="cuda"))
    except ValueError as e:
        log("transducer", f"(a) U+1 = 1025 raises: {e}")
    else:
        raise AssertionError("transducer_alphas took U+1 = 1025")
    if trl.transducer_alphas.launches != before:
        raise AssertionError("transducer_alphas launched for U+1 = 1025")
    # (b) serve
    transducer_serve(torch, np, cfg, smi)
    # (c) train: float32 parity, then the timed bf16 steps
    phase_train_parity(torch, np, cfg, tag="train-parity[transducer]")
    steps = TRAIN_TIMED_STEPS
    launches, step_s, peak = phase_train(
        torch, np, transducer_conformer(torch.bfloat16),
        batch_size=RNNT_BATCH, labels=RNNT_LABELS, steps=steps,
        tag="train[transducer]", need_stats=("loss_rnnt",))
    n = cfg.num_encoder_layers
    want = expected_counts({"relpos_attention": n, "relpos_attention_bwd": n,
                            "prenorm_ffn": 2 * n, "prenorm_ffn_bwd": 2 * n,
                            "transducer_alphas": 1,
                            "transducer_occupancy": 1}, steps)
    if launches != want:
        raise AssertionError(f"transducer: {steps} train steps launched "
                             f"{launches}, expected {want}")
    log("transducer", f"(c) B={RNNT_BATCH} x {TRAIN_SECONDS} s, U="
        f"{RNNT_LABELS}, V={cfg.vocab_size}, bf16: {step_s * 1e3:.1f} "
        f"ms/step, {RNNT_BATCH * TRAIN_SECONDS / step_s:.1f} audio-s/s, "
        f"peak {peak:.2f} GiB [{smi}]; launches exact")
    # (d) the CLIs
    transducer_cli(torch, np, smi)
    log("transducer", f"phase {time.perf_counter() - t0:.1f}s")
    return main, launches


# the asr-families phase: the rest of what the JAX ASRModel selects, at
# full width (random weights from seed 0): the longformer (the slice's main
# path: fused_ffn 2 a layer), the v1 VGG-BLSTM + AttLoc model, and on the
# bench conformer at 2 layers the S4 decoder, the sinc frontend and the
# multichannel frontend without and with DNN-WPE; then v1 window streaming
# and CTC forced alignment
FAMILY_LAYERS = 2
FAMILY_BATCH = 16  # the 2-layer cases' B (x 15 s)
MULTICHANNEL_BATCH = 2  # the multichannel cases' (4.3-7.3 s a step at 4)
VGG_TIMED_STEPS = 1  # vgg_blstm_rnn's timed steps (2.0-2.7 s each)
FAMILY_SCORE_RTOL = 1e-4
FFN_PAIR = ("fused_ffn", "fused_ffn_bwd")


def family_inputs(np, cfg, speech):
    """The requests' waveforms as the configuration takes them: (B, N, 2)
    for the multichannel frontend (the second channel the first delayed
    by 3 samples at half the level), else (B, N)."""
    if cfg.num_channels > 1:
        return np.stack([speech, 0.5 * np.roll(speech, 3, axis=1)], axis=2)
    return speech


def family_serve(torch, np, name, cfg, per_encode, per_step, smi,
                 device="cuda"):
    """Beam 10 (CTC 0.3, SERVE_STEPS label steps) on the 4 requests in
    float32, after a 2-step warm-up: the
    kernel route's launches exact (one encode, `per_step` a decoder step),
    its token ids equal to the plain route's and its scores within
    FAMILY_SCORE_RTOL; the float32 encoder output against the plain
    route's. (device="cpu" with a small config rehearses it where there is
    no card: no launch is then expected.)"""
    import dataclasses

    from espnet_tpu_torch.decode.asr_inference import Speech2Text

    if device != "cuda":
        per_encode, per_step = {}, {}
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = variant_model(torch, cfg)
    s2t = Speech2Text(model, device=device, beam_size=10, ctc_weight=0.3,
                      max_steps=2)
    speech, lengths = requests(np)
    speech = family_inputs(np, cfg, speech)
    s2t(speech, lengths)  # warm-up: the first calls, a 2-step search
    sync(torch, device)
    s2t.max_steps = SERVE_STEPS
    steps = []
    score_step = model.decoder_score_step

    def counted(*a, **k):
        steps.append(1)
        return score_step(*a, **k)

    model.decoder_score_step = counted
    wrappers = reset_counts()
    t = time.perf_counter()
    got = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {n: fn.launches for n, fn in wrappers.items()}
    del model.decoder_score_step
    want = expected_counts(per_encode, 1)
    for k, v in per_step.items():
        want[k] += v * len(steps)
    if counts != want:
        raise AssertionError(f"{name}: serving launched {counts}, expected "
                             f"{want} ({len(steps)} decoder steps)")
    model.set_use_kernels(False)
    plain = s2t(speech, lengths, nbest=10)
    sp = torch.from_numpy(speech).to(device)
    ln = torch.from_numpy(lengths).to(device)
    with torch.no_grad():
        enc_p, olens = model.encode(sp, ln)
        model.set_use_kernels(True)
        enc_k, _ = model.encode(sp, ln)
    valid = (torch.arange(enc_k.shape[1], device=device)[None, :]
             < olens[:, None])[:, :, None]
    dev = float(((enc_k - enc_p).abs() * valid).max())
    worst = max(abs(g.score - w.score) / max(1.0, abs(w.score))
                for g, w in zip(got, plain))
    same = all(g.nbest[0][0] == w.nbest[0][0] for g, w in zip(got, plain))
    audio = float(sum(REQUEST_SECONDS))
    log("asr-families", f"{name} serve float32, beam 10: wall {wall:.3f}s, "
        f"RTF {wall / audio:.5f} [{smi}]; tokens "
        f"{[len(r.token_ids) for r in got]}, equal to the plain route's "
        f"{same}, worst relative score dev {worst:.2e} (limit "
        f"{FAMILY_SCORE_RTOL}); encoder output kernels vs plain max |dev| "
        f"{dev:.3e} (limit {ENCODER_FP32_TOL}); {len(steps)} decoder "
        f"steps; launches exact {({k: v for k, v in counts.items() if v})}")
    if not same or worst > FAMILY_SCORE_RTOL or dev > ENCODER_FP32_TOL:
        raise AssertionError(f"{name}: the kernel route's serve differs "
                             "from the plain route's")
    if not all(np.isfinite(r.score) and all(
            0 <= i < cfg.vocab_size for i in r.token_ids) for r in got):
        raise AssertionError(f"{name}: bad results")


def family_train(torch, np, name, cfg, per_step, batch_size, steps, smi,
                 parity, device="cuda", seconds=TRAIN_SECONDS):
    """(a float32 train step with kernels against plain,) then `steps`
    timed steps of `cfg` at batch_size x `seconds` with exact launches."""
    if device != "cuda":
        per_step = {}
    speech = train_batch(np, batch_size, [seconds] * batch_size,
                         TRAIN_LABELS, cfg.vocab_size, 0)
    speech["speech"] = family_inputs(np, cfg, speech["speech"])
    if parity:
        pb = train_batch(np, len(REQUEST_SECONDS), REQUEST_SECONDS, 20,
                         cfg.vocab_size, 2)
        pb["speech"] = family_inputs(np, cfg, pb["speech"])
        phase_train_parity(torch, np, cfg, device=device,
                           tag=f"train-parity[{name}]", batch=pb)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, batch_size=batch_size,
        seconds=seconds, steps=steps, tag=f"train[{name}]", batch=speech)
    check_case_launches(name, f"{steps} train steps", launches, per_step,
                        steps)
    log("asr-families", f"{name} train {cfg.dtype} B={batch_size} x "
        f"{seconds} s: {step_s * 1e3:.1f} ms/step, "
        f"{batch_size * seconds / step_s:.1f} audio-s/s, peak "
        f"{peak:.2f} GiB [{smi}]; launches exact")


def family_window(torch, np, smi, cfg, device="cuda"):
    """(d) WindowStreamingASR on the VGG-LSTM `cfg`, float32: one window
    holding a request equals the offline decode; then the request in
    0.512 s windows, timed."""
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.decode.streaming_v1 import WindowStreamingASR

    model = variant_model(torch, cfg)
    s2t = Speech2Text(model, device=device, beam_size=10, ctc_weight=0.3,
                      max_steps=40)
    speech, lengths = requests(np)
    wave = speech[-1, :lengths[-1]]
    offline = s2t(wave[None], lengths[-1:], nbest=10)[0].nbest
    one = WindowStreamingASR(s2t)
    one.accept_input(wave)
    single = one.decode_with_attention_offline()
    if single != offline:
        raise AssertionError("asr-families: one window differs from the "
                             f"offline decode: {single[0]} vs {offline[0]}")
    win = WindowStreamingASR(s2t)
    hop = 8192
    sync(torch, device)
    t = time.perf_counter()
    for i in range(0, len(wave), hop):
        win.accept_input(wave[i:i + hop])
    sync(torch, device)
    feed = time.perf_counter() - t
    t = time.perf_counter()
    hyps = win.decode_with_attention_offline()
    final = time.perf_counter() - t
    n = -(-len(wave) // hop)
    log("asr-families", f"(d) vgg_lstm window streaming float32: one window "
        f"equals the offline decode ({len(single[0][0])} tokens); "
        f"{n} windows of {hop / SAMPLE_RATE:.3f} s: {feed / n * 1e3:.2f} "
        f"ms a window, final decode {final:.3f}s, "
        f"{len(hyps[0][0])} tokens [{smi}]")


def family_align(torch, np, smi, device="cuda"):
    """(e) bin.asr_align on the JAX-trained synth_hard experiment's 300 test
    utterances, a subprocess with its launch log, against the plain
    route's segments computed here."""
    import os
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin.asr_align import align_lines
    from espnet_tpu_torch.bin.asr_inference import load_experiment
    from espnet_tpu_torch.ops.launches import LAUNCH_LOG_ENV

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_align_"))
    try:
        log_path = ws / "launches.jsonl"
        argv = ["--exp_dir", SYNTH_EXP, "--data_dir", f"{SYNTH}/data/test",
                "--output_dir", str(ws / "align"), "--params", SYNTH_PARAMS,
                "--batch_size", "30", "--device", device]
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "espnet_tpu_torch.bin.asr_align", *argv],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, **{LAUNCH_LOG_ENV: str(log_path)}))
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:], flush=True)
            raise AssertionError(f"asr_align exited {proc.returncode}")
        got = (ws / "align" / "segments").read_text().splitlines()
        model, data, ds, _, conv = load_experiment(
            Path(SYNTH_EXP), f"{SYNTH}/data/test", SYNTH_PARAMS)
        model.set_use_kernels(False)
        want = align_lines(model, data, ds, conv, 30, device)
        if got != want:
            bad = [(g, w) for g, w in zip(got, want) if g != w]
            raise AssertionError(f"asr_align: the kernel route's segments "
                                 f"differ from the plain route's: "
                                 f"{len(got)} vs {len(want)} lines, "
                                 f"{bad[:3]}")
        (call,) = [json.loads(ln) for ln in log_path.read_text().splitlines()]
        layers = model.config.num_encoder_layers
        n_batches = len(cli_batches(ds, data, 30))
        per = ({"relpos_attention": layers, "prenorm_ffn": 2 * layers}
               if device == "cuda" else {})
        check_case_launches("asr_align", "aligning", call["launches"], per,
                            n_batches)
        utts = len({ln.split()[0] for ln in got})
        log("asr-families", f"(e) bin.asr_align on synth_hard's {len(ds)} "
            f"test utterances: {len(got)} segments of {utts} utterances, "
            f"equal to the plain route's; {wall:.1f}s with process start "
            f"[{smi}]; launches exact ({n_batches} batches)")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def phase_asr_families(torch, np, smi):
    """(a) the longformer at full width: serve, a float32 step with
    kernels against plain, 3 bf16 steps at B=64 x 15 s; (b) vgg_blstm_rnn:
    serve and 1 bf16 step at B=64; (c) the S4 decoder, sinc and
    multichannel (with and without WPE) models at 2 layers: serve and one
    bf16 step at B=16 (multichannel B=8); (d) v1 window streaming; (e)
    bin.asr_align."""
    from espnet_tpu_torch.configs import (FAMILIES, bench_config,
                                          longformer_conformer,
                                          vgg_blstm_rnn)

    t0 = time.perf_counter()
    # (a) the slice's main path
    ffn = {"fused_ffn": 2 * L}
    family_serve(torch, np, "longformer", longformer_conformer(
        torch.float32), ffn, {}, smi)
    family_train(torch, np, "longformer", longformer_conformer(
        torch.bfloat16), {"fused_ffn": 2 * L, "fused_ffn_bwd": 2 * L, **CTC},
        TRAIN_BATCH, TRAIN_TIMED_STEPS, smi, parity=True)
    # (b) v1 VGG-BLSTM + AttLoc: only the CTC pair is a kernel there
    family_serve(torch, np, "vgg_blstm_rnn", vgg_blstm_rnn(torch.float32),
                 {}, {}, smi)
    family_train(torch, np, "vgg_blstm_rnn", vgg_blstm_rnn(torch.bfloat16),
                 CTC, TRAIN_BATCH, VGG_TIMED_STEPS, smi, parity=False)
    # (c) the 2-layer conformer cases
    n = FAMILY_LAYERS
    conformer = ({"relpos_attention": n, "prenorm_ffn": 2 * n},
                 {"relpos_attention": n, "relpos_attention_bwd": n,
                  "prenorm_ffn": 2 * n, "prenorm_ffn_bwd": 2 * n, **CTC})
    for name, overrides in FAMILIES.items():
        cfg = bench_config(torch.bfloat16, num_encoder_layers=n, **overrides)
        per_step, train_step = {}, dict(conformer[1])
        if cfg.decoder_type == "s4":  # its FFN: fused_ffn, one a block
            per_step = {"fused_ffn": cfg.num_decoder_layers}
            train_step.update({k: cfg.num_decoder_layers for k in FFN_PAIR})
        family_serve(torch, np, name, cfg, conformer[0], per_step, smi)
        batch = (MULTICHANNEL_BATCH if cfg.num_channels > 1
                 else FAMILY_BATCH)
        family_train(torch, np, name, cfg, train_step, batch, 1, smi,
                     parity=False)
    family_window(torch, np, smi,
                  vgg_blstm_rnn(torch.float32, encoder_type="vgg_lstm"))
    family_align(torch, np, smi)
    log("asr-families", f"phase {time.perf_counter() - t0:.1f}s")


# the asr-multi phase: Mask-CTC, multi-encoder and multi-speaker ASR and the
# transformer LM at full width (random weights from seed 0; the JAX
# packages' defaults, configs.py), each case with its exact kernel
# launches; then the LM's CLIs and shallow fusion on the JAX-trained
# synth_hard experiment
MULTI_SCORE_RTOL = 1e-4
MASKCTC_ITERATIONS = 10
MULENC_LAYERS, MIX_LAYERS = 4, 4 + 2 * 4  # encoder layers of a stream; of
# the shared and branch stacks
LM_LAYERS = 6
LM_BATCH, LM_TOKENS = 64, 256
# the LM CLIs on synth_hard's test text (300 lines, its character tokens):
# a smoke test of training, not an evaluation
LM_CLI_ARGS = ("--run.max_epoch 5 --run.log_interval 1 "
               "--optim.schedule constant --optim.lr 0.001")
LM_FUSION_WEIGHT = 0.3


def multi_inputs(np, kind):
    """The 4 requests as the case's model takes them: mulenc, each request
    as 2 streams (the clean wave and a noisier copy; (B, N, 2), lengths
    (B, 2)); asr_mix, each request mixed with the next one at 0.7 (the
    longer length); else the waveforms."""
    speech, lengths = requests(np)
    if kind == "mulenc":
        noise = np.random.RandomState(7).randn(*speech.shape) * 0.05
        valid = np.arange(speech.shape[1])[None, :] < lengths[:, None]
        noisy = (speech + noise * valid).astype(np.float32)
        return (np.stack([speech, noisy], axis=2),
                np.stack([lengths, lengths], axis=1))
    if kind == "asr_mix":
        mix = speech.copy()
        nxt = np.roll(np.arange(len(lengths)), -1)
        mix += 0.7 * speech[nxt]
        return mix, np.maximum(lengths, lengths[nxt])
    return speech, lengths


def multi_train_batch(np, kind, b, seconds, u, vocab, seed):
    """train_batch's waveforms and labels in the case's layout: two streams
    with their (B, 2) lengths for mulenc; two speakers' labels (B, 2, U)
    with (B, 2) lengths for asr_mix."""
    batch = train_batch(np, b, seconds, u, vocab, seed)
    if kind == "mulenc":
        sp = batch["speech"]
        noisy = sp + 0.05 * np.random.RandomState(seed + 1).randn(*sp.shape)
        batch["speech"] = np.stack([sp, noisy.astype(np.float32)], axis=2)
        batch["speech_lengths"] = np.stack([batch["speech_lengths"]] * 2, 1)
    elif kind == "asr_mix":
        other = np.random.RandomState(seed + 1).randint(1, vocab - 1, (b, u))
        batch["text"] = np.stack([batch["text"], other.astype(np.int32)], 1)
        batch["text_lengths"] = np.stack(
            [batch["text_lengths"], np.maximum(batch["text_lengths"] - 3, 1)],
            1)
    return batch


def multi_serve(torch, np, name, cfg, run, encode, per_encode, per_call,
                counted, smi, device="cuda", phase="asr-multi",
                audio=None):
    """Serve the case's 4 requests in float32 through `run(model)` (a list
    of comparable results: token ids, or (ids, score)); the launches exact
    (one encode, `per_call` for each call of the model's `counted` method);
    the kernel route's results equal to the plain route's (scores within
    MULTI_SCORE_RTOL) and `encode(model)` ((out, valid)) within
    ENCODER_FP32_TOL; `phase` tags the lines, `audio` is the seconds of
    audio served (the requests' by default; 0: text). Returns the wall
    seconds."""
    import dataclasses

    from espnet_tpu_torch.models.asr import init_random_

    if device != "cuda":
        per_encode, per_call = {}, {}
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = init_random_(build_model(cfg), torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    with torch.no_grad():
        run(model)  # warm-up
    sync(torch, device)
    calls = []
    if counted:
        method = getattr(model, counted)

        def counting(*a, **k):
            calls.append(1)
            return method(*a, **k)

        setattr(model, counted, counting)
    wrappers = reset_counts()
    t = time.perf_counter()
    with torch.no_grad():
        got = run(model)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {n: fn.launches for n, fn in wrappers.items()}
    if counted:
        delattr(model, counted)
    want = expected_counts(per_encode, 1)
    for k, v in per_call.items():
        want[k] += v * len(calls)
    if counts != want:
        raise AssertionError(f"{name}: serving launched {counts}, expected "
                             f"{want} ({len(calls)} {counted} calls)")
    with torch.no_grad():
        model.set_use_kernels(False)
        plain = run(model)
        enc_p, valid = encode(model)
        model.set_use_kernels(True)
        enc_k, _ = encode(model)
    dev = float(((enc_k - enc_p).abs() * valid).max())
    same, worst = True, 0.0
    for g, p in zip(got, plain):
        if isinstance(g, tuple):
            same &= g[0] == p[0]
            worst = max(worst, abs(g[1] - p[1]) / max(1.0, abs(p[1])))
        else:
            same &= g == p
    audio = float(sum(REQUEST_SECONDS)) if audio is None else audio
    rtf = f"RTF {wall / audio:.5f}" if audio else "text input"
    log(phase, f"{name} serve float32: wall {wall:.3f}s, {rtf} [{smi}]; "
        f"results equal to the plain route's {same}, worst relative score dev {worst:.2e} (limit "
        f"{MULTI_SCORE_RTOL}); encoder output kernels vs plain max |dev| "
        f"{dev:.3e} (limit {ENCODER_FP32_TOL}); "
        f"{f'{len(calls)} {counted} calls; ' if counted else ''}launches exact {({k: v for k, v in counts.items() if v})}")
    if not same or worst > MULTI_SCORE_RTOL or dev > ENCODER_FP32_TOL:
        raise AssertionError(f"{name}: the kernel route's serve differs from "
                             "the plain route's")
    return wall


def multi_train(torch, np, name, cfg, kind, per_step, smi, need_stats,
                device="cuda"):
    """A float32 train step with kernels against plain on the requests, then
    TRAIN_TIMED_STEPS bf16 steps at B=64 x 15 s, U=40, exact launches."""
    if device != "cuda":
        per_step = {}
    pb = multi_train_batch(np, kind, len(REQUEST_SECONDS), REQUEST_SECONDS,
                           20, cfg.vocab_size, 2)
    phase_train_parity(torch, np, cfg, device=device,
                       tag=f"train-parity[{name}]", batch=pb)
    batch = multi_train_batch(np, kind, TRAIN_BATCH,
                              [TRAIN_SECONDS] * TRAIN_BATCH, TRAIN_LABELS,
                              cfg.vocab_size, 0)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, tag=f"train[{name}]", batch=batch,
        need_stats=need_stats)
    check_case_launches(name, f"{TRAIN_TIMED_STEPS} train steps", launches,
                        per_step, TRAIN_TIMED_STEPS)
    log("asr-multi", f"{name} train {cfg.dtype} B={TRAIN_BATCH} x "
        f"{TRAIN_SECONDS} s: {step_s * 1e3:.1f} ms/step, "
        f"{TRAIN_BATCH * TRAIN_SECONDS / step_s:.1f} audio-s/s, peak "
        f"{peak:.2f} GiB [{smi}]; launches exact")


def multi_kernels(torch, np):
    """The kernels at the shapes only these paths give them, float32 and
    bf16, against their plain versions: the pre-norm FFN forward and
    backward at the training rows (M=64*T') of the Mask-CTC conformer
    (F=2048) and the asr_mix one (F=1024; both swish, residual scale 0.5)
    and of the mulenc transformer encoders (F=1024, relu, 1.0); rel-pos
    attention forward and backward at the conformers' T', flash attention
    at the mulenc encoders' T' and at the MLM decoder's training shape
    (B=64, T=40: it takes the bare labels) with the batch's full lengths
    and with ragged ones; `fused_ffn` forward and backward at the LM's
    rows (M=64*257, F=1024, relu, dropout 0.1) and the HAN decoder's
    (M=64*41); and in float32 the new `ctc_loss_from_log_probs` (the
    lattice pair with the occupancy as the gradient) at the multi-speaker
    shape (B=64, T'=469, V=5000, U=40): its loss and its gradient with
    respect to the log-probs against its plain lattice (each valid frame's
    gradient sums to -1, an infeasible utterance's is 0), and through
    log_softmax against torch's ctc_loss."""
    import torch.nn.functional as F

    from espnet_tpu_torch.configs import (asr_mix_conformer,
                                          maskctc_conformer,
                                          mulenc_transformer)
    from espnet_tpu_torch.models.subsampling import subsampled_length
    from espnet_tpu_torch.ops.ctc import ctc_loss_from_log_probs
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)
    from espnet_tpu_torch.ops.stft import stft_frames_lengths
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)

    b, u = TRAIN_BATCH, TRAIN_LABELS
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for role, rows in (("lm", b * (LM_TOKENS + 1)),
                           ("mulenc decoder", b * (u + 1))):
            args, (flops, nbytes), (bflops, bbytes) = fused_ffn_case(
                torch, rows, dtype, 21, f=1024)
            kw = {"activation": "relu", "drop_rate": 0.1, "seed": 2718}
            label = f"{role} M={rows} D=256 F=1024 relu dropout 0.1"
            with torch.no_grad():
                check_kernel(torch, "fused_ffn", fused_ffn, fused_ffn_plain,
                             args, flops, nbytes, dn, label, kw, iters=5)
            gout = torch.randn(rows, 256, generator=torch.Generator()
                               .manual_seed(22)).to("cuda", dtype)
            check_grads(torch, "fused_ffn_bwd", dn, label,
                        lambda *a: fused_ffn(*a, **kw),
                        lambda *a: fused_ffn_plain(*a, **kw), args, 5, gout,
                        bflops, bbytes, iters=5)
        for lengths, how in (([u] * b, "full labels"),
                             ([u - (i % 9) for i in range(b)], "ragged")):
            args, flops, nbytes, _ = flash_case(torch, b, u, dtype, lengths,
                                                23)
            with torch.no_grad():
                check_kernel(torch, "flash_attention", flash_attention,
                             flash_attention_plain, args, flops, nbytes, dn,
                             f"maskctc MLM decoder B={b} H=4 T={u} D=64 "
                             f"{how}", iters=10)
    def train_frames(mcfg):
        frames = stft_frames_lengths(
            torch.tensor([int(TRAIN_SECONDS * SAMPLE_RATE)]), mcfg.n_fft,
            mcfg.hop_length)
        return int(subsampled_length(frames, mcfg.subsampling_factor)[0])

    for mcfg, name, act, scale in (
            (maskctc_conformer(torch.bfloat16), "maskctc conformer",
             "swish", 0.5),
            (asr_mix_conformer(torch.bfloat16), "asr_mix conformer",
             "swish", 0.5),
            (mulenc_transformer(torch.bfloat16), "mulenc transformer",
             "relu", 1.0)):
        tp = train_frames(mcfg)
        check_ffn_rows(torch, mcfg, b * tp, f"{name} M={b}x{tp}", act, scale)
    # the encoders' attention at their own T' (every utterance 15 s long):
    # rel-pos in the Mask-CTC and asr_mix conformers, flash in the mulenc
    # transformers
    tr = train_frames(maskctc_conformer(torch.bfloat16))
    if tr != train_frames(asr_mix_conformer(torch.bfloat16)):
        raise AssertionError("asr-multi: the conformers' T' differ")
    tf = train_frames(mulenc_transformer(torch.bfloat16))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        es = 4 if dtype == torch.float32 else 2
        args, flops, nbytes = relpos_case(torch, b, tr, dtype, [tr] * b, 25)
        label = f"maskctc/asr_mix encoders B={b} H=4 T={tr} D=64"
        with torch.no_grad():
            check_kernel(torch, "relpos_attention", relpos_attention,
                         relpos_attention_plain, args, flops, nbytes, dn,
                         label, iters=5)
        gout = torch.randn(b, 4, tr, 64, generator=torch.Generator()
                           .manual_seed(26)).to("cuda", dtype)
        check_grads(torch, "relpos_attention_bwd", dn, label,
                    relpos_attention, relpos_attention_plain, args, 6, gout,
                    16.0 * b * 4 * tr * tr * 64,
                    (7 * b * 4 * tr * 64 + 2 * 4 * (2 * tr - 1) * 64) * es
                    + b * tr * 4 + b * 4 * tr * 12, iters=5)
        args, flops, nbytes, _ = flash_case(torch, b, tf, dtype, [tf] * b, 27)
        with torch.no_grad():
            check_kernel(torch, "flash_attention", flash_attention,
                         flash_attention_plain, args, flops, nbytes, dn,
                         f"mulenc encoders B={b} H=4 T={tf} D=64", iters=5)
    t, v = 469, 5000
    logits, labels, in_lens, lab_lens, _, _ = ctc_case(torch, np, b, t, u, v,
                                                        24)
    def through_logits(loss_fn):
        """(per-utterance loss, d logits) of loss_fn(log_softmax(logits))."""
        x = logits.clone().requires_grad_(True)
        loss = loss_fn(torch.log_softmax(x, -1))
        loss.sum().backward()
        return loss.detach(), x.grad

    lk, gk = through_logits(lambda lp: ctc_loss_from_log_probs(
        lp, labels, in_lens, lab_lens))
    lpl, gp = through_logits(lambda lp: ctc_loss_from_log_probs(
        lp, labels, in_lens, lab_lens, use_kernels=False))
    ll, gl = through_logits(lambda lp: F.ctc_loss(
        lp.transpose(0, 1), labels, in_lens, lab_lens, blank=0,
        reduction="none", zero_infinity=True))
    loss_dev = float(((lk - lpl).abs() / lpl.abs()).max())
    grad_dev = float((gk - gp).abs().max())
    lib_dev = float(((lk - ll).abs() / ll.abs()).max())
    lib_grad = float((gk - gl).abs().max())
    lp = torch.log_softmax(logits, -1)
    # d log-probs directly: a softmax term left in the gradient would
    # vanish through log_softmax above, so hold it here, with the last
    # utterance cut too short for its labels (loss and gradient 0)
    short = in_lens.clone()
    short[-1] = lab_lens[-1] // 2

    def direct(use):
        x = lp.clone().requires_grad_(True)
        loss = ctc_loss_from_log_probs(x, labels, short, lab_lens,
                                       use_kernels=use)
        loss.sum().backward()
        return loss.detach(), x.grad

    dk_loss, dk = direct(True)
    dp_loss, dp = direct(False)
    lp_dev = float((dk - dp).abs().max())
    lp_loss_dev = float(((dk_loss - dp_loss).abs()
                         / dp_loss.abs().clamp(min=1.0)).max())
    valid = (torch.arange(t, device=lp.device)[None, :]
             < short[:, None]).float()
    valid[-1] = 0.0  # infeasible: no frame carries occupancy
    sum_dev = float((dk.sum(-1) + valid).abs().max())
    infeasible = float(dk_loss[-1].abs()) + float(dk[-1].abs().max())
    log("asr-multi", f"ctc_loss_from_log_probs d log-probs (one infeasible "
        f"utterance): kernel pair vs plain lattice max |dev| {lp_dev:.2e} "
        f"(limit {CTC_GRAD_ATOL}), loss relative {lp_loss_dev:.2e} (limit "
        f"{CTC_LOSS_RTOL}); each frame's gradient sum against -1 (valid) "
        f"or 0 max |dev| {sum_dev:.2e} (limit {CTC_OCC_SUM_ATOL}); "
        f"infeasible loss + |grad| "
        f"{infeasible:.1e}")
    if (lp_dev > CTC_GRAD_ATOL or sum_dev > CTC_OCC_SUM_ATOL or infeasible
            or lp_loss_dev > CTC_LOSS_RTOL):
        raise AssertionError("ctc_loss_from_log_probs: its gradient with "
                             "respect to the log-probs disagrees with the "
                             "plain lattice's or is not -occupancy")

    def step(use):
        x = lp.clone().requires_grad_(True)
        ctc_loss_from_log_probs(x, labels, in_lens, lab_lens,
                                use_kernels=use).sum().backward()

    ms = time_ms(torch, lambda: step(True), 10)
    plain_ms = time_ms(torch, lambda: step(False), 3)
    dev_ms = device_ms(torch, lambda: step(True))
    log("asr-multi", f"ctc_loss_from_log_probs B={b} T={t} V={v} U={u} "
        f"float32, forward and backward: kernel pair vs plain lattice loss "
        f"relative {loss_dev:.2e} (limit {CTC_LOSS_RTOL}), d logits (through "
        f"log_softmax) max |dev| {grad_dev:.2e} (limit {CTC_GRAD_ATOL}); vs "
        f"torch.nn.functional.ctc_loss loss {lib_dev:.2e}, gradient "
        f"{lib_grad:.2e}; {ms:.4f} ms (device "
        f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms), plain "
        f"{plain_ms:.4f} ms")
    if max(loss_dev, lib_dev) > CTC_LOSS_RTOL or max(
            grad_dev, lib_grad) > CTC_GRAD_ATOL:
        raise AssertionError("ctc_loss_from_log_probs disagrees with its "
                             "plain version or torch's ctc_loss")


def multi_lm_train(torch, np, smi, device="cuda"):
    """The transformer LM: a float32 step with kernels against plain, then
    TRAIN_TIMED_STEPS bf16 steps at B=64 x 256 tokens (fused_ffn forward
    and backward, one a layer; causal attention plain)."""
    from espnet_tpu_torch.configs import LM_VOCAB, transformer_lm
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.tasks.lm import LM_BATCH_KEYS, LMTask
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    rng = np.random.RandomState(0)

    def batch(b):
        return {"text": torch.from_numpy(rng.randint(
                    1, LM_VOCAB - 1, (b, LM_TOKENS))).to(device),
                "text_lengths": torch.from_numpy(
                    LM_TOKENS - rng.randint(0, 32, b)).to(device)}

    mc = transformer_lm(dropout_rate=0.0)
    model = init_random_(LMTask.build_model(mc, LM_VOCAB),
                         torch.Generator().manual_seed(1)).to(device).train()
    pb = batch(4)
    res = {}
    for use in (True, False):
        model.set_use_kernels(use)
        loss, _ = model(pb["text"], pb["text_lengths"])
        res[use] = (float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters())))
    model.set_use_kernels(True)
    (lk, gk), (lp, gp) = res[True], res[False]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gp)))
    whole = float(torch.sqrt(sum(((a.double() - b.double()) ** 2).sum()
                                 for a, b in zip(gk, gp)))) / total
    log("asr-multi", f"train-parity[transformer_lm] float32 B=4 x "
        f"{LM_TOKENS} tokens: loss kernels {lk:.6f} vs plain {lp:.6f}; "
        f"whole gradient relative L2 {whole:.2e} (limit "
        f"{TRAIN_FP32_GRAD_REL_L2})")
    if abs(lk - lp) / abs(lp) > TRAIN_FP32_LOSS_RTOL or \
            whole > TRAIN_FP32_GRAD_REL_L2:
        raise AssertionError("transformer_lm: the float32 step with kernels "
                             "deviates from the plain one")
    model = init_random_(LMTask.build_model(transformer_lm(), LM_VOCAB,
                                            torch.bfloat16),
                         torch.Generator().manual_seed(0))
    tx = build_optimizer("fused_adam", lr=1e-3, schedule="warmuplr",
                         warmup_steps=25000, d_model=mc.d_model)
    step = make_train_step(model, tx, device=device, batch_keys=LM_BATCH_KEYS)
    state = TrainState.create(model, tx)
    data = batch(LM_BATCH)
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, data, gen)  # warm-up
    sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        state, stats = step(state, data, gen)
        if not (np.isfinite(float(stats["loss"])) and float(
                stats["skipped"]) == 0.0):
            raise AssertionError(f"transformer_lm: step {stats}")
    sync(torch, device)
    step_s = (time.perf_counter() - t) / TRAIN_TIMED_STEPS
    counts = {n: fn.launches for n, fn in wrappers.items()}
    per = ({"fused_ffn": LM_LAYERS, "fused_ffn_bwd": LM_LAYERS}
           if device == "cuda" else {})
    check_case_launches("transformer_lm", "train steps", counts, per,
                        TRAIN_TIMED_STEPS)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else float("nan"))
    tokens = float(data["text_lengths"].sum()) + LM_BATCH
    log("asr-multi", f"transformer_lm train bf16 B={LM_BATCH} x {LM_TOKENS} "
        f"tokens: {step_s * 1e3:.1f} ms/step, {tokens / step_s:.0f} "
        f"tokens/s, peak {peak:.2f} GiB, ppl {float(stats['ppl']):.1f} "
        f"[{smi}]; launches exact")


def lm_cli_batches(np, data_dir, token_list, batch_size, quantum):
    """The LM task's batches of `data_dir`'s text (its sampler's)."""
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.tasks.lm import TextDataset

    ds = TextDataset(f"{data_dir}/text", build_tokenizer("char"),
                     TokenIDConverter.from_file(token_list))
    return build_batches({"text": ds.text_lengths()}, batch_size=batch_size,
                         length_quantum=quantum, text_quantum=quantum,
                         input_field="text")


def multi_lm_cli(torch, np, smi, device="cuda"):
    """bin.lm_train on synth_hard's test text with its token list and
    bin.lm_calc_perplexity, in process with their launch counts (a
    subprocess's start costs 8-10 s on a busy host); then
    bin.asr_inference on synth_hard's 300 test utterances without and with
    that LM (--lm_exp_dir, --lm_weight 0.3): WER and RTF of each, the
    encoder's launches exact and `fused_ffn` 6 a call of the LM's
    score_step."""
    import importlib
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_inference
    from espnet_tpu_torch.models.lm import TransformerLM
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.tasks.lm import LMTask

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    try:
        tokens = f"{SYNTH}/exp/tokens/tokens.txt"
        data = f"{SYNTH}/data/test"
        exp = ws / "lm"
        calls = [("lm_train", LM_CLI_ARGS.split() + [
            "--data.train_dir", data, "--data.valid_dir", data,
            "--data.token_list", tokens, "--run.output_dir", str(exp)]),
            ("lm_calc_perplexity", ["--exp_dir", str(exp), "--data_dir",
                                    data, "--output_dir", str(ws / "ppl")])]
        walls, logged = [], []
        for cli, argv in calls:
            main = importlib.import_module(f"espnet_tpu_torch.bin.{cli}").main
            _, counts, wall = counted_call(main, [*argv, "--device", device])
            walls.append(wall)
            logged.append({"cli": cli, "launches": counts})
        cfg = LMTask.load_config(exp)
        epochs = cfg["run"].max_epoch
        n = len(lm_cli_batches(np, data, tokens, cfg["data"].batch_size,
                               cfg["data"].text_quantum))
        n_ppl = -(-len(Path(data, "text").read_text().splitlines()) // 32)
        per = LM_LAYERS if device == "cuda" else 0
        want = expected_counts({"fused_ffn": per * 2 * epochs,
                                "fused_ffn_bwd": per * epochs}, n)
        check_launches("lm_train", logged[0]["launches"], want)
        check_launches("lm_calc_perplexity", logged[1]["launches"],
                       expected_counts({"fused_ffn": per}, n_ppl))
        ppl = (ws / "ppl" / "ppl").read_text().strip()
        log("asr-multi", f"bin.lm_train ({epochs} x {n} batches on "
            f"synth_hard's test text) {walls[0]:.1f}s, bin.lm_calc_perplexity "
            f"{walls[1]:.1f}s: perplexity {ppl} [{smi}]; "
            f"launches exact")
        steps = []
        score_step = TransformerLM.score_step

        def counting(self, *a, **k):
            steps.append(1)
            return score_step(self, *a, **k)

        acfg = ASRTask.load_config(SYNTH_EXP)
        tok = ASRTask.build_tokenizer(acfg["data"], Path(SYNTH_EXP))
        conv = ASRTask.build_token_list(acfg["data"], Path(SYNTH_EXP), tok)
        ds = ASRTask.build_dataset(acfg["data"], data, tok, conv,
                                   train=False)
        n_batches = len(cli_batches(ds, acfg["data"], 30))
        layers = acfg["model"].num_encoder_layers
        results = {}
        for tag, extra in (("without LM", []),
                           ("with the LM", ["--lm_exp_dir", str(exp),
                                            "--lm_weight",
                                            str(LM_FUSION_WEIGHT)])):
            out = ws / f"decode_{len(results)}"
            TransformerLM.score_step = counting
            steps.clear()
            wrappers = reset_counts()
            try:
                asr_inference.main(["--exp_dir", SYNTH_EXP, "--data_dir",
                                    data, "--output_dir", str(out),
                                    "--params", SYNTH_PARAMS, *SYNTH_DECODE,
                                    "--device", device, *extra])
            finally:
                TransformerLM.score_step = score_step
            counts = {k: fn.launches for k, fn in wrappers.items()}
            want = expected_counts(
                {"relpos_attention": layers, "prenorm_ffn": 2 * layers}
                if device == "cuda" else {}, n_batches)
            want["fused_ffn"] = per * len(steps)
            check_launches(f"asr_inference {tag}", counts, want)
            results[tag] = ((out / "score_wer.txt").read_text().strip()
                            .splitlines()[0],
                            (out / "rtf.txt").read_text().strip(),
                            len(steps))
        if results["with the LM"][2] == 0:
            raise AssertionError("asr-multi: the LM was never called")
        for tag, (wer, rtf, n_steps) in results.items():
            log("asr-multi", f"bin.asr_inference synth_hard's {len(ds)} "
                f"test utterances {tag} (beam 5, CTC 0.3, LM weight "
                f"{LM_FUSION_WEIGHT if n_steps else 0}): {wer}; {rtf} "
                f"[{smi}]; {n_steps} LM steps; launches exact")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def phase_asr_multi(torch, np, smi):
    """Mask-CTC, multi-encoder and multi-speaker ASR and the transformer
    LM at full width: for each, serve the 4 requests in float32 (the kernel
    route against the plain route), a float32 train step with kernels
    against plain and 3 bf16 steps at B=64 x 15 s (the LM: x 256 tokens),
    exact launches; the kernels at these paths' own shapes; then the LM
    CLIs and shallow fusion on synth_hard."""
    from espnet_tpu_torch.bin.asr_mix_inference import greedy_paths
    from espnet_tpu_torch.bin.asr_mulenc_inference import Speech2TextMulEnc
    from espnet_tpu_torch.configs import (asr_mix_conformer,
                                          maskctc_conformer,
                                          mulenc_transformer)
    from espnet_tpu_torch.models.maskctc import MaskCTCInference

    t0 = time.perf_counter()
    multi_kernels(torch, np)

    def tensors(kind):
        speech, lengths = multi_inputs(np, kind)
        return (torch.from_numpy(speech).cuda(),
                torch.from_numpy(lengths).cuda())

    # (1) Mask-CTC: the encoder once, the MLM decoder's flash attention a
    # layer for each infilling call
    sp, ln = tensors("maskctc")

    def maskctc_run(model):
        return MaskCTCInference(model, n_iterations=MASKCTC_ITERATIONS)(
            sp.cpu().numpy(), ln.cpu().numpy())

    def plain_encode(model):
        """(encoder output, its valid frames broadcastable to it)."""
        enc, olens = model.encode(sp, ln)
        valid = torch.arange(enc.shape[-2], device=enc.device) < olens[
            ..., None]
        while valid.ndim < enc.ndim - 1:  # asr_mix: (B, S, T', D), (B,)
            valid = valid[:, None]
        return enc, valid[..., None]

    cfg = maskctc_conformer(torch.bfloat16)
    multi_serve(torch, np, "maskctc_conformer", cfg, maskctc_run,
                plain_encode, CONFORMER[0],
                {"flash_attention": cfg.num_decoder_layers}, "mlm_logits",
                smi)
    multi_train(torch, np, "maskctc_conformer", cfg, "maskctc",
                {**CONFORMER[1], "flash_attention": cfg.num_decoder_layers},
                smi, ("loss_ctc", "loss_mlm", "acc_mlm"))

    # (2) mulenc: two transformer stacks (flash attention and the pre-norm
    # FFN a layer), the HAN decoder's fused_ffn a layer a search step
    sp, ln = tensors("mulenc")

    def mulenc_run(model):
        yseq, ylen, score = Speech2TextMulEnc(
            model, None, beam_size=10, ctc_weight=0.3,
            max_steps=SERVE_STEPS).decode_batch(sp, ln)
        return [(yseq[i, 0, :ylen[i, 0]].tolist(), float(score[i, 0]))
                for i in range(yseq.shape[0])]

    cfg = mulenc_transformer(torch.bfloat16)
    enc_layers = cfg.num_encoders * MULENC_LAYERS
    multi_serve(torch, np, "mulenc_transformer", cfg, mulenc_run,
                plain_encode, {"flash_attention": enc_layers,
                               "prenorm_ffn": enc_layers},
                {"fused_ffn": cfg.num_decoder_layers},
                "decoder_score_step", smi)
    multi_train(torch, np, "mulenc_transformer", cfg, "mulenc",
                {"flash_attention": enc_layers, "prenorm_ffn": enc_layers,
                 "prenorm_ffn_bwd": enc_layers,
                 "fused_ffn": cfg.num_decoder_layers,
                 "fused_ffn_bwd": cfg.num_decoder_layers,
                 "ctc_alphas": cfg.num_encoders,
                 "ctc_gamma": cfg.num_encoders},
                smi, ("loss_ctc1", "loss_ctc2", "loss_att"))

    # (3) asr_mix: 12 conformer blocks (4 shared, 4 a branch); the S x S
    # CTC pairs a step
    sp, ln = tensors("asr_mix")

    def mix_run(model):
        paths, elens = greedy_paths(model, sp, ln)
        return [paths[i, :, :elens[i]].tolist()
                for i in range(paths.shape[0])]

    cfg = asr_mix_conformer(torch.bfloat16)
    pairs = cfg.num_spk ** 2
    multi_serve(torch, np, "asr_mix_conformer", cfg, mix_run, plain_encode,
                {"relpos_attention": MIX_LAYERS,
                 "prenorm_ffn": 2 * MIX_LAYERS}, {}, None, smi)
    multi_train(torch, np, "asr_mix_conformer", cfg, "asr_mix",
                {"relpos_attention": MIX_LAYERS,
                 "relpos_attention_bwd": MIX_LAYERS,
                 "prenorm_ffn": 2 * MIX_LAYERS,
                 "prenorm_ffn_bwd": 2 * MIX_LAYERS,
                 "ctc_alphas": pairs, "ctc_gamma": pairs},
                smi, ("loss_ctc", "loss_att", "acc"))

    # (4) the transformer LM, its CLIs and shallow fusion
    multi_lm_train(torch, np, smi)
    multi_lm_cli(torch, np, smi)
    log("asr-multi", f"phase {time.perf_counter() - t0:.1f}s")


# the lm-fusion phase: the JAX-trained synth_hard conformer decoded with the
# n-gram, the word LMs and the time-synchronous search; every LM trained on
# its training transcripts (data/train/text), perplexities held out on its
# test transcripts
FUSION_SUBSET = 50  # the first 50 sorted test utterances: the host search
# of every case and both routes stay within the phase's budget
FUSION_PINNED = 4  # the first 4: tests/test_torch_ngram.py pins their
# n-gram texts (the reference transcripts) on the CPU
FUSION_WEIGHT = 0.3  # the n-gram's and the word LM's fusion weight
NGRAM_ORDER = 3
FUSION_LM_ARGS = ("--run.max_epoch 3 --run.log_interval 1000 "
                  "--model.lm_type rnn --model.d_model 256 "
                  "--model.num_layers 2 --model.dropout_rate 0.0 "
                  "--optim.schedule constant --optim.lr 0.002 "
                  "--data.batch_size 32")
FUSION_CASES = {  # case: asr_inference flags ({ngram}, {wlm}, {clm})
    "label_sync": "",
    "ngram": "--ngram_file {ngram} --ngram_weight 0.3",
    "lookahead": "--word_lm_exp_dir {wlm} --lm_weight 0.3",
    "multilevel": "--word_lm_exp_dir {wlm} --lm_exp_dir {clm} "
                  "--lm_weight 0.3",
    "timesync": "--search timesync",
    "timesync_ngram": "--search timesync --ngram_file {ngram} "
                      "--ngram_weight 0.3",
}
FUSED = ("ngram", "lookahead", "multilevel", "timesync_ngram")


def fusion_decode(ws, case, argv, plain, want, device="cuda"):
    """bin.asr_inference with `argv`, on the kernel route or the plain one
    (the model's kernels switched off once it is loaded): (texts, the WER
    line, the RTF line, the LM score steps: calls of the search's combined
    scorer, or of the n-gram's prefix scorer in the time-synchronous
    search); the launches must be `want` (none on the plain route)."""
    from espnet_tpu_torch.bin import asr_inference
    from espnet_tpu_torch.decode import asr_inference as s2t_module
    from espnet_tpu_torch.lm.ngram import DenseNgramScorer

    steps = []
    load = asr_inference.load_experiment
    combine = s2t_module.combine_scorers
    prefix_scorer = DenseNgramScorer.prefix_scorer

    def plain_load(*a, **k):
        out = load(*a, **k)
        out[0].set_use_kernels(False)
        return out

    def counting_combine(*a, **k):
        fn, cache = combine(*a, **k)
        if fn is None:
            return fn, cache

        def counted(*x):
            steps.append(1)
            return fn(*x)

        return counted, cache

    def counting_prefix_scorer(self):
        lm_score = prefix_scorer(self)

        def counted(*a):
            steps.append(1)
            return lm_score(*a)

        return counted

    route = "plain" if plain else "kernels"
    out = ws / f"decode_{case}_{route}"
    if plain:
        asr_inference.load_experiment = plain_load
    s2t_module.combine_scorers = counting_combine
    DenseNgramScorer.prefix_scorer = counting_prefix_scorer
    wrappers = reset_counts()
    try:
        hyps = asr_inference.main(argv + ["--output_dir", str(out),
                                          "--device", device])
    finally:
        asr_inference.load_experiment = load
        s2t_module.combine_scorers = combine
        DenseNgramScorer.prefix_scorer = prefix_scorer
    counts = {name: fn.launches for name, fn in wrappers.items()}
    check_launches(f"lm-fusion {case} {route}", counts,
                   expected_counts({}, 0) if plain or device != "cuda"
                   else want)
    return (hyps, (out / "score_wer.txt").read_text().splitlines()[0],
            (out / "rtf.txt").read_text().strip(), len(steps))


def ngram_perplexity(np, arpa, tokenizer, texts):
    """Per-token perplexity of the n-gram on `texts` (</s> counted)."""
    from espnet_tpu_torch.lm.ngram import NgramModel

    model = NgramModel.load_arpa(arpa)
    logp, n = 0.0, 0
    for text in texts:
        toks = tokenizer.text2tokens(text)
        logp += model.sentence_logp(toks)
        n += len(toks) + 1
    return float(10.0 ** (-logp / n))


def phase_lm_fusion(torch, np, smi, device="cuda", lm_args=FUSION_LM_ARGS,
                    subset=FUSION_SUBSET):
    """The n-gram, the word LMs and the time-synchronous search on the
    JAX-trained synth_hard conformer: `bin.ngram_train` (3-gram) and
    `bin.lm_train` (a word RNN LM, a character RNN LM) on its training
    transcripts with their held-out perplexities on the test transcripts,
    then `bin.asr_inference` on the first `subset` test utterances in
    each FUSION_CASES case (beam 5, CTC 0.3, 60 steps, weights 0.3), on
    the kernel route and, but for the unfused label-synchronous baseline,
    on the plain route: float32 texts equal on both routes, the n-gram's
    pinned texts the reference transcripts, launches exact; WER, RTF and
    LM score steps printed. (device="cpu" with smaller `lm_args` and
    `subset` rehearses the phase without a card.)"""
    import shlex
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import lm_calc_perplexity, lm_train, ngram_train
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.tasks.asr import ASRTask

    t0 = time.perf_counter()
    train = f"{SYNTH}/data/train"
    if not Path(train, "text").exists():
        raise FileNotFoundError(f"lm-fusion: the checkout lacks {train}/text")
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_fusion_"))
    try:
        keys = sorted(read_2column_text(f"{SYNTH}/data/test/wav.scp"))[
            :subset]
        for f in ("wav.scp", "text"):
            rows = read_2column_text(f"{SYNTH}/data/test/{f}")
            write_2column_text(ws / "test" / f, {k: rows[k] for k in keys})
        arpa = ws / f"{NGRAM_ORDER}gram.arpa"
        t = time.perf_counter()
        ngram_train.main(["--data_dir", train, "--exp_dir", SYNTH_EXP,
                          "--output", str(arpa), "--order",
                          str(NGRAM_ORDER)])
        cfg = ASRTask.load_config(SYNTH_EXP)
        tok = ASRTask.build_tokenizer(cfg["data"], Path(SYNTH_EXP))
        held_out = list(read_2column_text(f"{SYNTH}/data/test/text")
                        .values())
        ppl = {"ngram": ngram_perplexity(np, arpa, tok, held_out)}
        log("lm-fusion", f"bin.ngram_train {NGRAM_ORDER}-gram on "
            f"{train}/text: {time.perf_counter() - t:.1f}s, held-out "
            f"perplexity {ppl['ngram']:.4f} a character token")
        for name, extra in (("word", ["--data.token_type", "word"]),
                            ("char", ["--data.token_list",
                                      f"{SYNTH}/exp/tokens/tokens.txt"])):
            wrappers = reset_counts()
            t = time.perf_counter()
            _, trainer, _, _, conv = lm_train.main(
                shlex.split(lm_args) + extra + [
                    "--data.train_dir", train, "--run.output_dir",
                    str(ws / f"{name}_lm"), "--device", device])
            wall = time.perf_counter() - t
            check_launches(f"lm-fusion {name} lm_train",
                           {k: fn.launches for k, fn in wrappers.items()},
                           expected_counts({}, 0))
            ppl[name] = lm_calc_perplexity.main([
                "--exp_dir", str(ws / f"{name}_lm"), "--data_dir",
                f"{SYNTH}/data/test", "--output_dir",
                str(ws / f"{name}_ppl"), "--device", device])
            losses = [round(trainer.reporter.epochs[e]["train"]["loss"], 4)
                      for e in sorted(trainer.reporter.epochs)]
            log("lm-fusion", f"bin.lm_train {name} RNN LM ({len(conv)} "
                f"tokens) on {train}/text: {wall:.1f}s, train "
                f"loss by epoch {losses}; held-out perplexity "
                f"{ppl[name]:.4f} (bin.lm_calc_perplexity on the test "
                f"transcripts) [{smi}]")
        ds = ASRTask.build_dataset(cfg["data"], ws / "test", tok,
                                   ASRTask.build_token_list(
                                       cfg["data"], Path(SYNTH_EXP), tok),
                                   train=False)
        layers = cfg["model"].num_encoder_layers
        want = expected_counts({"relpos_attention": layers,
                                "prenorm_ffn": 2 * layers},
                               len(cli_batches(ds, cfg["data"], 30)))
        base = ["--exp_dir", SYNTH_EXP, "--params", SYNTH_PARAMS,
                "--data_dir", str(ws / "test"), *SYNTH_DECODE]
        refs = read_2column_text(f"{SYNTH}/exp/decode_test/text")
        paths = {"ngram": arpa, "wlm": ws / "word_lm", "clm": ws / "char_lm"}
        for case, flags in FUSION_CASES.items():
            argv = base + shlex.split(flags.format(**paths))
            hyps, wer, rtf, steps = fusion_decode(ws, case, argv, False,
                                                  want, device)
            same = "kernel route only"
            if case != "label_sync":
                plain = fusion_decode(ws, case, argv, True, want,
                                      device)[0]
                if plain != hyps:
                    bad = [k for k in hyps if plain.get(k) != hyps[k]]
                    raise AssertionError(
                        f"lm-fusion {case}: float32 texts on the kernel "
                        f"route differ from the plain route's on {bad[:3]}")
                same = "texts equal on both routes"
            if (steps > 0) != (case in FUSED):
                raise AssertionError(f"lm-fusion {case}: {steps} LM steps")
            if case == "ngram":
                pinned = keys[:FUSION_PINNED]
                if [hyps[k] for k in pinned] != [refs[k] for k in pinned]:
                    raise AssertionError(
                        "lm-fusion ngram: the pinned texts differ from the "
                        "CPU port's")
            shown = flags.format(ngram=arpa.name, wlm="word_lm",
                                 clm="char_lm")
            log("lm-fusion", f"{case} ({shown or 'no LM'}) on "
                f"{len(hyps)} utterances: {wer}; {rtf}; {steps} LM score "
                f"steps; {same}; launches exact [{smi}]")
        log("lm-fusion", f"phase {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# the translation phase: MT, ST and SLU at the JAX configs' widths
# (configs.mt_transformer, st_conformer; random weights from a seed)
MT_SENTENCES, MT_BEAM, MT_STEPS = 16, 10, 64
MT_BATCH, MT_MIN_TOKENS, MT_MAX_TOKENS = 64, 16, 128
MT_LAYERS, ST_LAYERS = 6, 12
ST_BEAM, ST_STEPS = 10, SERVE_STEPS
MT_BATCH_KEYS = ("src_text", "src_text_lengths", "text", "text_lengths")
ST_BATCH_KEYS = BATCH_KEYS + ("src_text", "src_text_lengths")
TRANSLATION_CLI_ARGS = ("--run.max_epoch 2 --run.log_interval 1000 "
                        "--run.best_metric valid.loss.min "
                        "--optim.schedule constant --optim.lr 0.001")
MT_PER_ENCODE = {"flash_attention": MT_LAYERS, "prenorm_ffn": MT_LAYERS}
MT_PER_STEP = {**MT_PER_ENCODE, "prenorm_ffn_bwd": MT_LAYERS}
ST_PER_ENCODE = {"relpos_attention": ST_LAYERS,
                 "prenorm_ffn": 2 * ST_LAYERS}
ST_PER_STEP = {**ST_PER_ENCODE, "relpos_attention_bwd": ST_LAYERS,
               "prenorm_ffn_bwd": 2 * ST_LAYERS, "ctc_alphas": 1,
               "ctc_gamma": 1}


def mt_batch(np, b, vocab, seed, src_vocab=None):
    """Seeded ragged sentence pairs: source and target lengths uniform in
    [MT_MIN_TOKENS, MT_MAX_TOKENS] (the first pair at the maximum)."""
    rng = np.random.RandomState(seed)
    out = {}
    for field, v in (("src_text", src_vocab or vocab), ("text", vocab)):
        lens = rng.randint(MT_MIN_TOKENS, MT_MAX_TOKENS + 1, b)
        lens[0] = MT_MAX_TOKENS
        ids = rng.randint(1, v - 1, (b, MT_MAX_TOKENS))
        ids[np.arange(MT_MAX_TOKENS)[None, :] >= lens[:, None]] = 0
        out[field] = ids.astype(np.int32)
        out[field + "_lengths"] = lens.astype(np.int32)
    return out


def st_batch(np, b, seconds, u, vocab, src_vocab, seed):
    """train_batch's waveforms and labels with `u` source labels."""
    batch = train_batch(np, b, seconds, u, vocab, seed)
    rng = np.random.RandomState(seed + 1)
    batch["src_text"] = rng.randint(1, src_vocab - 1, (b, u)).astype(
        np.int32)
    batch["src_text_lengths"] = np.full((b,), u, np.int32)
    return batch


def translation_kernels(torch, np):
    """Flash attention forward at the MT encoder's training shape (B=64,
    H=4, T_src=128, D=64, ragged lengths 16-128) and the pre-norm FFN
    forward and backward at its rows (M=64*128, D=256, F=2048, relu,
    residual 1.0, dropout 0.1), float32 and bf16, against their plain
    versions."""
    from espnet_tpu_torch.configs import mt_transformer
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)

    lengths = mt_batch(np, MT_BATCH, 100, 3)["src_text_lengths"].tolist()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args, flops, nbytes, _ = flash_case(torch, MT_BATCH, MT_MAX_TOKENS,
                                            dtype, lengths, 31)
        with torch.no_grad():
            check_kernel(torch, "flash_attention", flash_attention,
                         flash_attention_plain, args, flops, nbytes, dn,
                         f"mt encoder B={MT_BATCH} H=4 T={MT_MAX_TOKENS} "
                         f"D=64 ragged {min(lengths)}-{max(lengths)}",
                         iters=10)
    check_ffn_rows(torch, mt_transformer(torch.bfloat16),
                   MT_BATCH * MT_MAX_TOKENS,
                   f"mt encoder M={MT_BATCH}x{MT_MAX_TOKENS}", "relu", 1.0)


def translation_mt(torch, np, smi, device="cuda", cfg=None):
    """mt_transformer: 16 sentences served (beam 10, 64 steps) in float32
    with the kernel route against the plain route; a float32 train step
    with kernels against plain; 1 + 3 bf16 steps at B=64 ragged pairs.
    (device="cpu" with a small `cfg` rehearses it without a card.)"""
    from espnet_tpu_torch.configs import mt_transformer
    from espnet_tpu_torch.decode.asr_inference import Speech2Text

    cfg = cfg or mt_transformer(torch.bfloat16)
    on_card = device == "cuda"
    serve = mt_batch(np, MT_SENTENCES, cfg.vocab_size, 5,
                     cfg.src_vocab_size)
    src = torch.from_numpy(serve["src_text"]).to(device)
    slen = torch.from_numpy(serve["src_text_lengths"]).to(device)

    def run(model):
        yseq, ylen, score = Speech2Text(
            model, device=device, beam_size=MT_BEAM, ctc_weight=0.0,
            max_steps=MT_STEPS).decode_batch(src, slen)
        return [(yseq[i, 0, :ylen[i, 0]].tolist(), float(score[i, 0]))
                for i in range(yseq.shape[0])]

    def encode(model):
        enc, olens = model.encode(src, slen)
        valid = torch.arange(enc.shape[1], device=enc.device)[None] < \
            olens[:, None]
        return enc, valid[..., None]

    multi_serve(torch, np, "mt_transformer", cfg, run, encode,
                MT_PER_ENCODE, {}, None, smi, device=device,
                phase="translation", audio=0)
    pb = mt_batch(np, 4, cfg.vocab_size, 6, cfg.src_vocab_size)
    phase_train_parity(torch, np, cfg, device=device,
                       tag="train-parity[mt_transformer]", batch=pb,
                       keys=MT_BATCH_KEYS)
    batch = mt_batch(np, MT_BATCH, cfg.vocab_size, 0, cfg.src_vocab_size)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, batch_size=MT_BATCH, seconds=0.0,
        labels=MT_MAX_TOKENS, tag="train[mt_transformer]", batch=batch,
        need_stats=("loss", "acc"), keys=MT_BATCH_KEYS)
    check_case_launches("mt_transformer", f"{TRAIN_TIMED_STEPS} train "
                        "steps", launches, MT_PER_STEP if on_card else {},
                        TRAIN_TIMED_STEPS)
    tokens = int(batch["src_text_lengths"].sum()
                 + batch["text_lengths"].sum()) + MT_BATCH
    log("translation", f"mt_transformer train bf16 B={MT_BATCH} pairs of "
        f"{MT_MIN_TOKENS}-{MT_MAX_TOKENS} tokens: {step_s * 1e3:.1f} "
        f"ms/step, {tokens / step_s:.0f} tokens/s, peak {peak:.2f} GiB "
        f"[{smi}]; launches exact")


def translation_st(torch, np, smi, device="cuda", cfg=None):
    """st_conformer: the 4 requests served (beam 10, SERVE_STEPS steps, CTC
    weight 0) in float32, the kernel route against the plain route; a float32
    train step with kernels against plain; 3 bf16 steps at B=64 x 15 s
    with 40 target and 40 source labels. (device="cpu" with a small `cfg`
    rehearses it without a card.)"""
    from espnet_tpu_torch.configs import st_conformer
    from espnet_tpu_torch.decode.asr_inference import Speech2Text

    cfg = cfg or st_conformer(torch.bfloat16)
    on_card = device == "cuda"
    speech, lengths = requests(np)
    sp = torch.from_numpy(speech).to(device)
    ln = torch.from_numpy(lengths).to(device)

    def run(model):
        yseq, ylen, score = Speech2Text(
            model, device=device, beam_size=ST_BEAM, ctc_weight=0.0,
            max_steps=ST_STEPS).decode_batch(sp, ln)
        return [(yseq[i, 0, :ylen[i, 0]].tolist(), float(score[i, 0]))
                for i in range(yseq.shape[0])]

    def encode(model):
        enc, olens = model.encode(sp, ln)
        valid = torch.arange(enc.shape[1], device=enc.device)[None] < \
            olens[:, None]
        return enc, valid[..., None]

    multi_serve(torch, np, "st_conformer", cfg, run, encode, ST_PER_ENCODE,
                {}, None, smi, device=device, phase="translation")
    pb = st_batch(np, len(REQUEST_SECONDS), REQUEST_SECONDS, 20,
                  cfg.vocab_size, cfg.src_vocab_size, 2)
    phase_train_parity(torch, np, cfg, device=device,
                       tag="train-parity[st_conformer]", batch=pb,
                       keys=ST_BATCH_KEYS)
    batch = st_batch(np, TRAIN_BATCH, [TRAIN_SECONDS] * TRAIN_BATCH,
                     TRAIN_LABELS, cfg.vocab_size, cfg.src_vocab_size, 0)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, batch_size=TRAIN_BATCH,
        seconds=TRAIN_SECONDS, labels=TRAIN_LABELS,
        tag="train[st_conformer]", batch=batch,
        need_stats=("loss_st", "loss_asr_ctc", "acc"), keys=ST_BATCH_KEYS)
    check_case_launches("st_conformer", f"{TRAIN_TIMED_STEPS} train steps",
                        launches, ST_PER_STEP if on_card else {},
                        TRAIN_TIMED_STEPS)
    log("translation", f"st_conformer train bf16 B={TRAIN_BATCH} x "
        f"{TRAIN_SECONDS} s, {TRAIN_LABELS} target and source labels: "
        f"{step_s * 1e3:.1f} ms/step, "
        f"{TRAIN_BATCH * TRAIN_SECONDS / step_s:.1f} audio-s/s, peak "
        f"{peak:.2f} GiB [{smi}]; launches exact")


def counted_call(fn, argv):
    """fn(argv) with the launch counters set to 0 first: (its result, the
    counts, the wall seconds)."""
    wrappers = reset_counts()
    t = time.perf_counter()
    out = fn(argv)
    return (out, {k: w.launches for k, w in wrappers.items()},
            time.perf_counter() - t)


def translation_clis(torch, np, smi, device="cuda", model_args=()):
    """Both CLIs of MT, ST and SLU in-process on synthetic corpora at the
    CLIs' default widths: `mt_train` (2 epochs) then `mt_inference`;
    `st_train` (2 epochs, utterance MVN) then `st_inference`; `slu_train`
    (1 epoch, transcripts led by an intent word) then `slu_inference` on
    its data and on synth_hard's FUSION_SUBSET test utterances, where the
    intent accuracy must be 1.0. Each with its exact launches.
    (device="cpu" with `model_args`, flags that shrink the MT, ST and SLU
    models, rehearses it without a card.)"""
    import shlex
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import (mt_inference, mt_train, slu_inference,
                                      slu_train, st_inference, st_train)
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.synth import (generate_corpus,
                                             generate_mt_corpus,
                                             generate_st_corpus)
    from espnet_tpu_torch.data.tokenizer import TokenIDConverter
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.tasks.mt import MTDataset, MTTask
    from espnet_tpu_torch.tasks.st import STTask

    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_translation_"))
    common = shlex.split(TRANSLATION_CLI_ARGS) + list(model_args)
    dev = ["--device", device]

    def per_batches(*parts):
        """The launches of (per-call counts, calls) parts, summed (none
        off the card)."""
        want = expected_counts({}, 0)
        for per, n in parts:
            for k, v in per.items():
                want[k] += v * n if device == "cuda" else 0
        return want

    try:
        # MT: 256 + 32 sentence pairs (the target the source reversed)
        generate_mt_corpus(ws / "mt_train", n_utts=256, max_words=6, seed=0)
        generate_mt_corpus(ws / "mt_valid", n_utts=32, max_words=6, seed=1)
        exp = ws / "mt_exp"
        (_, trainer, _, tok, conv), counts, wall = counted_call(
            mt_train.main, common + [
                "--data.train_dir", str(ws / "mt_train"),
                "--data.valid_dir", str(ws / "mt_valid"),
                "--run.output_dir", str(exp), *dev])
        data = MTTask.load_config(exp)["data"]
        src_conv = TokenIDConverter.from_file(exp / "src_tokens.txt")
        n_train, n_valid = (len(MTTask.make_batches(
            MTDataset(ws / d, tok, conv, src_conv), data))
            for d in ("mt_train", "mt_valid"))
        epochs = len(trainer.epoch_seconds)
        check_launches("mt_train", counts, per_batches(
            (MT_PER_STEP, epochs * n_train),
            (MT_PER_ENCODE, epochs * n_valid)))
        log("translation", f"bin.mt_train: {epochs} epochs of {n_train} "
            f"batches + {n_valid} validation, {wall:.1f}s; launches exact")
        _, counts, wall = counted_call(mt_inference.main, [
            "--exp_dir", str(exp), "--data_dir", str(ws / "mt_valid"),
            "--output_dir", str(ws / "mt_dec"), *dev])
        n_dec = -(-32 // 16)
        check_launches("mt_inference", counts,
                       per_batches((MT_PER_ENCODE, n_dec)))
        log("translation", f"bin.mt_inference (beam 10, 64 steps) on 32 "
            f"sentences: {wall:.1f}s, "
            f"{(ws / 'mt_dec' / 'score_wer.txt').read_text().strip()}; "
            f"launches exact [{smi}]")

        # ST: 32 + 8 utterances (the translation the transcript reversed)
        generate_st_corpus(ws / "st_train", n_utts=32, max_words=4, seed=0)
        generate_st_corpus(ws / "st_valid", n_utts=8, max_words=4, seed=1)
        exp = ws / "st_exp"
        (_, trainer, _, tok, conv), counts, wall = counted_call(
            st_train.main, common + [
                "--data.train_dir", str(ws / "st_train"),
                "--data.valid_dir", str(ws / "st_valid"),
                "--data.batch_size", "8", "--model.normalize",
                "utterance_mvn", "--run.output_dir", str(exp), *dev])
        data = STTask.load_config(exp)["data"]
        src_conv = STTask.src_token_list(exp)
        n_train, n_valid = (len(STTask.make_batches(STTask.build_st_dataset(
            data, ws / d, tok, conv, src_conv), data))
            for d in ("st_train", "st_valid"))
        epochs = len(trainer.epoch_seconds)
        eval_step = {**ST_PER_ENCODE, "ctc_alphas": 1}
        check_launches("st_train", counts, per_batches(
            (ST_PER_STEP, epochs * n_train), (eval_step, epochs * n_valid)))
        log("translation", f"bin.st_train: {epochs} epochs of {n_train} "
            f"batches + {n_valid} validation, {wall:.1f}s; launches exact")
        _, counts, wall = counted_call(st_inference.main, [
            "--exp_dir", str(exp), "--data_dir", str(ws / "st_valid"),
            "--output_dir", str(ws / "st_dec"), "--max_steps",
            str(ST_STEPS), *dev])
        ds = STTask.build_dataset(data, ws / "st_valid", tok, conv,
                                  train=False)
        check_launches("st_inference", counts, per_batches(
            (ST_PER_ENCODE, len(cli_batches(ds, data, 8)))))
        log("translation", f"bin.st_inference (beam 10, {ST_STEPS} steps) "
            f"on 8 utterances: {wall:.1f}s, "
            f"{(ws / 'st_dec' / 'score_wer.txt').read_text().strip()}; "
            f"{(ws / 'st_dec' / 'rtf.txt').read_text().strip()}; launches "
            f"exact [{smi}]")

        # SLU: 16 utterances whose transcripts start with "play" or "stop"
        generate_corpus(ws / "slu", n_utts=16, seed=2)
        texts = read_2column_text(ws / "slu" / "text")
        write_2column_text(ws / "slu" / "text", {
            k: f"{'play' if i % 2 else 'stop'} {v}"
            for i, (k, v) in enumerate(texts.items())})
        exp = ws / "slu_exp"
        (_, trainer, _, tok, conv), counts, wall = counted_call(
            slu_train.main, [
                "--run.max_epoch", "1", "--run.log_interval", "1000",
                "--run.best_metric", "train.loss.min", "--data.batch_size",
                "8", "--data.train_dir", str(ws / "slu"),
                "--run.output_dir", str(exp), *list(model_args), *dev])
        data = ASRTask.load_config(exp)["data"]
        ds = ASRTask.build_dataset(data, ws / "slu", tok, conv)
        batches = cli_batches(ds, data, data.batch_size)
        want, _ = cli_expected(batches, [], 1, L)
        check_launches("slu_train", counts,
                       want if device == "cuda" else per_batches())
        log("translation", f"bin.slu_train: 1 epoch of {len(batches)} "
            f"batches with collect-stats, {wall:.1f}s; launches exact")
        for name, exp_dir, data_dir, extra, layers in (
                ("synthetic", exp, ws / "slu", [], L),
                ("synth_hard", Path(SYNTH_EXP), None,
                 ["--params", SYNTH_PARAMS], 6)):
            if data_dir is None:
                data_dir = ws / "synth_test"
                keys = sorted(read_2column_text(
                    f"{SYNTH}/data/test/wav.scp"))[:FUSION_SUBSET]
                for f in ("wav.scp", "text"):
                    rows = read_2column_text(f"{SYNTH}/data/test/{f}")
                    write_2column_text(data_dir / f,
                                       {k: rows[k] for k in keys})
            out = ws / f"slu_dec_{name}"
            _, counts, wall = counted_call(slu_inference.main, [
                "--exp_dir", str(exp_dir), "--data_dir", str(data_dir),
                "--output_dir", str(out), "--beam_size", "5",
                "--max_steps", "60", "--batch_size", "30", *extra, *dev])
            cfg = ASRTask.load_config(exp_dir)
            dtok = ASRTask.build_tokenizer(cfg["data"], Path(exp_dir))
            ds = ASRTask.build_dataset(
                cfg["data"], data_dir, dtok, ASRTask.build_token_list(
                    cfg["data"], Path(exp_dir), dtok), train=False)
            check_launches(f"slu_inference {name}", counts, per_batches(
                ({"relpos_attention": layers, "prenorm_ffn": 2 * layers},
                 len(cli_batches(ds, cfg["data"], 30)))))
            acc = (out / "intent_acc.txt").read_text().strip()
            wer = (out / "score_wer.txt").read_text().strip()
            if name == "synth_hard" and (acc != "1.0000"
                                         or "| Err 0.0 |" not in wer):
                raise AssertionError(f"slu_inference synth_hard: intent "
                                     f"accuracy {acc}, {wer}")
            log("translation", f"bin.slu_inference on {name} "
                f"({len(ds)} utterances): intent accuracy {acc}, {wer}; "
                f"{wall:.1f}s; launches exact [{smi}]")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def phase_translation(torch, np, smi):
    """MT, ST and SLU: the kernels at MT's shapes, mt_transformer and
    st_conformer served and trained, then their CLIs."""
    t0 = time.perf_counter()
    translation_kernels(torch, np)
    translation_mt(torch, np, smi)
    translation_st(torch, np, smi)
    translation_clis(torch, np, smi)
    log("translation", f"phase {time.perf_counter() - t0:.1f}s")


# the ssl phase: the SSL and Whisper parts of the ASR model and HuBERT
# pretraining at the published widths (configs.ssl_conformer, wav2vec2_ctc,
# whisper_base, hubert_pretrain; random weights from a seed)
SSL_BEAM, SSL_STEPS = 10, SERVE_STEPS
HUBERT_LAYERS = 6
HUBERT_KEYS = ("speech", "speech_lengths", "labels")
SSL_PER_ENCODE = {
    "ssl_conformer": {"relpos_attention": L, "prenorm_ffn": 2 * L},
    "wav2vec2_ctc": {},
    "whisper_base": {},
}
SSL_PER_STEP = {
    "ssl_conformer": {**CONFORMER[1]},
    "wav2vec2_ctc": dict(CTC),
    "whisper_base": {},
}
HUBERT_PER_STEP = {"flash_attention": HUBERT_LAYERS,
                   "prenorm_ffn": HUBERT_LAYERS,
                   "prenorm_ffn_bwd": HUBERT_LAYERS}
# the weight-norm collapse of the positional conv, w = g v / ||v||, rounds
# in float32 (every other transferred tensor is copied exactly)
WEIGHT_NORM_RTOL = 1e-5
SSL_CLI_UTTS = 16
SSL_CLI_ARGS = ("--run.max_epoch 1 --run.log_interval 1000 "
                "--run.best_metric train.loss.min --optim.schedule constant")
# the decoder's step log-probs against the teacher-forced ones (float32)
WHISPER_STEP_ATOL = 1e-4


def hubert_batch(np, b, seconds, classes, seed, hop=128):
    """Seeded noise waveforms with random k-means labels on the log-mel
    frame grid (hop 128: N // hop + 1 frames)."""
    rng = np.random.RandomState(seed)
    n = [int(sec * SAMPLE_RATE) for sec in seconds]
    speech = np.zeros((b, max(n)), np.float32)
    for i, k in enumerate(n):
        speech[i, :k] = 0.1 * rng.randn(k)
    frames = max(n) // hop + 1
    return {"speech": speech, "speech_lengths": np.array(n, np.int32),
            "labels": rng.randint(0, classes, (b, frames)).astype(np.int32)}


def ssl_kernels(torch, np):
    """Flash attention forward at HuBERT's training shape (B=64, H=4,
    T=1876, D=64) and the pre-norm FFN forward and backward at its rows
    (M=64*1876, D=256, F=1024, relu, residual 1.0, dropout 0.1), float32
    and bf16, against their plain versions: neither shape ran before."""
    from espnet_tpu_torch.configs import hubert_pretrain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from espnet_tpu_torch.ops.stft import stft_frames_lengths

    hcfg = hubert_pretrain(torch.bfloat16)
    t = int(stft_frames_lengths(torch.tensor([int(TRAIN_SECONDS
                                                  * SAMPLE_RATE)]),
                                hcfg.n_fft, hcfg.hop_length)[0])
    lengths = [t] * TRAIN_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args, flops, nbytes, _ = flash_case(torch, TRAIN_BATCH, t, dtype,
                                            lengths, 41)
        with torch.no_grad():
            check_kernel(torch, "flash_attention", flash_attention,
                         flash_attention_plain, args, flops, nbytes, dn,
                         f"hubert B={TRAIN_BATCH} H=4 T={t} D=64", iters=5)
        del args
    check_ffn_rows(torch, hcfg, TRAIN_BATCH * t,
                   f"hubert M={TRAIN_BATCH}x{t}", "relu", 1.0)
    return t


def whisper_step_check(torch, np, model, sp, ln, smi):
    """score_step over 12 positions with the KV cache of
    max_target_positions (448) rows against the teacher-forced decoder's
    log-probs, float32, on the requests' encoder output."""
    dec = model.decoder
    rng = np.random.RandomState(9)
    b, u = sp.shape[0], 12
    tokens = torch.from_numpy(rng.randint(
        1, dec.cfg.vocab_size - 1, (b, u))).to(sp.device)
    with torch.no_grad():
        mem, mlen = model.encode(sp, ln)
        full = torch.log_softmax(dec(tokens, torch.full(
            (b,), u, device=sp.device), mem, mlen).float(), -1)
        cache = dec.init_cache(b, dec.cfg.max_target_positions, sp.device)
        steps = []
        for pos in range(u):
            lp, cache = dec.score_step(tokens[:, pos], pos, mem, mlen, cache)
            steps.append(lp)
    dev = float((torch.stack(steps, 1) - full).abs().max())
    log("ssl", f"whisper_base score_step (cache {dec.cfg.max_target_positions}"
        f" rows) vs teacher-forced log-probs, {u} positions, float32: max "
        f"|dev| {dev:.3e} (limit {WHISPER_STEP_ATOL}) [{smi}]")
    if dev > WHISPER_STEP_ATOL:
        raise AssertionError("whisper score_step disagrees with the "
                             "teacher-forced decoder")


def ssl_case(torch, np, smi, name, device="cuda", cfg=None,
             batch_size=TRAIN_BATCH, seconds=TRAIN_SECONDS):
    """One of the SSL and Whisper configurations: serve the 4 requests in
    float32 (beam 10, SERVE_STEPS steps; Whisper's CTC weight 0) with the
    kernel route's results equal to the plain route's and the encoder output
    within 1e-3 (Whisper: also score_step against the teacher-forced
    log-probs), a float32 train step with kernels against plain (a frozen
    trunk gets no gradient), then 3 bf16 steps at `batch_size` x 15 s,
    each with its exact launches. (device="cpu" with a small `cfg`
    rehearses it without a card.)"""
    from espnet_tpu_torch import configs
    from espnet_tpu_torch.decode.asr_inference import Speech2Text

    cfg = cfg or getattr(configs, name)(torch.bfloat16)
    on_card = device == "cuda"
    per_encode = SSL_PER_ENCODE[name] if on_card else {}
    per_step = SSL_PER_STEP[name] if on_card else {}
    ctc_weight = 0.3 if cfg.ctc_weight > 0 else 0.0
    speech, lengths = requests(np)
    sp = torch.from_numpy(speech).to(device)
    ln = torch.from_numpy(lengths).to(device)

    def run(model):
        yseq, ylen, score = Speech2Text(
            model, device=device, beam_size=SSL_BEAM, ctc_weight=ctc_weight,
            max_steps=SSL_STEPS).decode_batch(sp, ln)
        return [(yseq[i, 0, :ylen[i, 0]].tolist(), float(score[i, 0]))
                for i in range(yseq.shape[0])]

    stepped = []

    def encode(model):
        enc, olens = model.encode(sp, ln)
        valid = torch.arange(enc.shape[1], device=enc.device)[None] < \
            olens[:, None]
        if cfg.decoder_type == "whisper" and not stepped:
            whisper_step_check(torch, np, model, sp, ln, smi)
            stepped.append(1)
        return enc, valid[..., None]

    multi_serve(torch, np, name, cfg, run, encode, per_encode, {}, None,
                smi, device=device, phase="ssl")
    unused = phase_train_parity(torch, np, cfg, device=device,
                                tag=f"train-parity[{name}]")
    frozen = cfg.input_type == "ssl" and cfg.ssl_freeze
    trunk = [n for n in unused if n.startswith("ssl_frontend.upstream.")]
    if (len(trunk) != len(unused)
            or bool(trunk) != frozen):
        raise AssertionError(f"{name}: parameters without a gradient "
                             f"{len(unused)} (trunk {len(trunk)}), frozen "
                             f"trunk {frozen}")
    batch = train_batch(np, batch_size, [seconds] * batch_size,
                        TRAIN_LABELS, cfg.vocab_size, 0)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, batch_size=batch_size,
        seconds=seconds, tag=f"train[{name}]", batch=batch,
        need_stats=("loss",))
    check_case_launches(name, f"{TRAIN_TIMED_STEPS} train steps", launches,
                        per_step, TRAIN_TIMED_STEPS)
    log("ssl", f"{name} train {cfg.dtype} B={batch_size} x {seconds} s: "
        f"{step_s * 1e3:.1f} ms/step, {batch_size * seconds / step_s:.1f} "
        f"audio-s/s, peak {peak:.2f} GiB [{smi}]; "
        f"{len(trunk)} frozen trunk tensors without a gradient; "
        f"launches exact {({k: v for k, v in launches.items() if v})}")


def ssl_hubert(torch, np, smi, device="cuda", cfg=None,
               batch_size=TRAIN_BATCH, seconds=TRAIN_SECONDS):
    """hubert_pretrain: a float32 train step with kernels against plain on
    the requests, then 3 bf16 steps at B=64 x 15 s with the exact flash
    and pre-norm FFN launches. Returns the timed steps' launches."""
    from espnet_tpu_torch.configs import hubert_pretrain

    cfg = cfg or hubert_pretrain(torch.bfloat16)
    pb = hubert_batch(np, len(REQUEST_SECONDS), REQUEST_SECONDS,
                      cfg.num_classes, 2, cfg.hop_length)
    phase_train_parity(torch, np, cfg, device=device,
                       tag="train-parity[hubert_pretrain]", batch=pb,
                       keys=HUBERT_KEYS)
    batch = hubert_batch(np, batch_size, [seconds] * batch_size,
                         cfg.num_classes, 0, cfg.hop_length)
    launches, step_s, peak = phase_train(
        torch, np, cfg, device=device, batch_size=batch_size,
        seconds=seconds, tag="train[hubert_pretrain]", batch=batch,
        need_stats=("loss_masked", "acc_masked", "mask_ratio"),
        keys=HUBERT_KEYS)
    check_case_launches("hubert_pretrain", f"{TRAIN_TIMED_STEPS} train "
                        "steps", launches,
                        HUBERT_PER_STEP if device == "cuda" else {},
                        TRAIN_TIMED_STEPS)
    rows = batch["labels"].shape[1]
    log("ssl", f"hubert_pretrain train {cfg.dtype} B={batch_size} x "
        f"{seconds} s ({rows} frames, no subsampling): {step_s * 1e3:.1f} "
        f"ms/step, {batch_size * seconds / step_s:.1f} audio-s/s, peak "
        f"{peak:.2f} GiB [{smi}]; launches exact")
    return launches


def hf_wav2vec2_state(trunk):
    """The port's Wav2Vec2Model as a HF Wav2Vec2Model state dict (numpy,
    HF key names; the positional conv as the weight-norm parametrization
    with g = ||v||, so that w = v)."""
    sd = {k: v.detach().cpu().numpy() for k, v in trunk.state_dict().items()}
    c = trunk.cfg
    out = {}
    for i in range(len(c.conv_dim)):
        out[f"feature_extractor.conv_layers.{i}.conv.weight"] = \
            sd[f"feature_extractor.conv{i}.weight"]
        norm = ("group_norm" if c.feat_extract_norm == "group" and i == 0
                else f"norm{i}" if c.feat_extract_norm == "layer" else None)
        if norm:
            for leaf in ("weight", "bias"):
                out[f"feature_extractor.conv_layers.{i}.layer_norm.{leaf}"] \
                    = sd[f"feature_extractor.{norm}.{leaf}"]
    names = {"feature_projection.layer_norm": "proj_norm",
             "feature_projection.projection": "projection",
             "encoder.layer_norm": "norm"}
    for i in range(c.num_layers):
        p, q = f"encoder.layers.{i}", f"layer{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            names[f"{p}.attention.{proj}"] = f"{q}.attention.{proj}"
        names[f"{p}.layer_norm"] = f"{q}.layer_norm"
        names[f"{p}.feed_forward.intermediate_dense"] = \
            f"{q}.intermediate_dense"
        names[f"{p}.feed_forward.output_dense"] = f"{q}.output_dense"
        names[f"{p}.final_layer_norm"] = f"{q}.final_layer_norm"
    for hf, port in names.items():
        for leaf in ("weight", "bias"):
            out[f"{hf}.{leaf}"] = sd[f"{port}.{leaf}"]
    v = sd["pos_conv.weight"]
    g = (v.astype("float64") ** 2).sum(axis=(0, 1), keepdims=True) ** 0.5
    pre = "encoder.pos_conv_embed.conv"
    out[f"{pre}.parametrizations.weight.original0"] = g.astype(v.dtype)
    out[f"{pre}.parametrizations.weight.original1"] = v
    out[f"{pre}.bias"] = sd["pos_conv.bias"]
    return out


def hf_whisper_state(encoder, decoder):
    """The port's Whisper encoder and decoder as a HF
    WhisperForConditionalGeneration state dict (keys under `model.`)."""
    out = {}

    def layer(sd, p, q, cross):
        attns = ["self_attn"] + (["encoder_attn"] if cross else [])
        for a in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                for leaf in ("weight", "bias"):
                    key = f"{q}.{a}.{proj}.{leaf}"
                    if key in sd:
                        out[f"{p}.{a}.{proj}.{leaf}"] = sd[key]
            for leaf in ("weight", "bias"):
                out[f"{p}.{a}_layer_norm.{leaf}"] = \
                    sd[f"{q}.{a}_layer_norm.{leaf}"]
        for m in ("fc1", "fc2", "final_layer_norm"):
            for leaf in ("weight", "bias"):
                out[f"{p}.{m}.{leaf}"] = sd[f"{q}.{m}.{leaf}"]

    for side, mod in (("encoder", encoder), ("decoder", decoder)):
        sd = {k: v.detach().cpu().numpy() for k, v in
              mod.state_dict().items()}
        pre = f"model.{side}"
        out[f"{pre}.embed_positions.weight"] = sd["positions"]
        for leaf in ("weight", "bias"):
            out[f"{pre}.layer_norm.{leaf}"] = sd[f"norm.{leaf}"]
        n = mod.cfg.encoder_layers if side == "encoder" else \
            mod.cfg.decoder_layers
        for i in range(n):
            layer(sd, f"{pre}.layers.{i}", f"layer{i}", side == "decoder")
        if side == "encoder":
            for conv in ("conv1", "conv2"):
                for leaf in ("weight", "bias"):
                    out[f"{pre}.{conv}.{leaf}"] = sd[f"{conv}.{leaf}"]
        else:
            out[f"{pre}.embed_tokens.weight"] = sd["embed_tokens.weight"]
    return out


def ssl_clis(torch, np, smi, device="cuda", hubert_args=(), w2v_ssl=None,
             whisper_cfg=None, asr_args=()):
    """In-process `bin.hubert_train` (one epoch on 16 synthetic utterances,
    the k-means stage on the device's log-mel), then `bin.convert_hf` on a
    full-width wav2vec2-base-layout `.safetensors` file (float32) and a
    whisper-base one (float16, keys under `model.`), both written here
    under HF's key names from random weights, and `bin.asr_train
    --run.init_param` from each converted file (learning rate 0: the
    epoch's parameters are the transferred ones): the transferred trunk
    and encoder equal the source weights. Each with its exact launches.
    (device="cpu" with small `w2v_ssl` / `whisper_cfg` and `hubert_args` /
    `asr_args` that shrink the models rehearses it without a card.)"""
    import json
    import shlex
    import shutil
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import asr_train, convert_hf, hubert_train
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.ssl import (SSLConfig, Wav2Vec2Model,
                                            WhisperConfig, WhisperDecoder,
                                            WhisperEncoder)
    from espnet_tpu_torch.tasks.hubert import HubertDataset, HubertTask
    from espnet_tpu_torch.train.hf_import import write_safetensors
    from espnet_tpu_torch.train.msgpack_io import flatten, load_tree

    on_card = device == "cuda"
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_ssl_"))
    common = shlex.split(SSL_CLI_ARGS)
    dev = ["--device", device]
    try:
        generate_corpus(ws / "data", n_utts=SSL_CLI_UTTS, seed=3)
        exp = ws / "hubert_exp"
        (_, trainer, _), counts, wall = counted_call(hubert_train.main, [
            *common, "--data.train_dir", str(ws / "data"),
            "--data.batch_size", "8", "--data.kmeans_iters", "5",
            "--optim.lr", "0.001", "--run.output_dir", str(exp),
            *hubert_args, *dev])
        cfg = HubertTask.load_config(exp)
        ds = HubertDataset(ws / "data", exp / "labels")
        n_batches = len(build_batches(
            {"speech": ds.speech_lengths()},
            batch_size=cfg["data"].batch_size,
            length_quantum=cfg["data"].length_quantum))
        layers = cfg["model"].num_encoder_layers
        check_launches("hubert_train", counts, expected_counts(
            {k: layers * n_batches for k in HUBERT_PER_STEP}
            if on_card else {}, 1))
        cents = np.load(exp / "km_centroids.npy")
        labels = sorted((exp / "labels").glob("*.npy"))
        if (cents.shape != (cfg["model"].num_classes, cfg["model"].n_mels)
                or len(labels) != SSL_CLI_UTTS
                or not (exp / "checkpoint.pt").exists()
                or not np.isfinite(cents).all()):
            raise AssertionError("hubert_train: missing or malformed "
                                 "centroids, labels or checkpoint")
        log("ssl", f"bin.hubert_train: k-means {cents.shape[0]} x "
            f"{cents.shape[1]} centroids, {len(labels)} label files, 1 "
            f"epoch of {n_batches} batches, "
            f"{trainer.epoch_seconds.get(1, float('nan')):.1f}s train, "
            f"{wall:.1f}s in all; launches exact [{smi}]")

        gen = torch.Generator().manual_seed(5)
        scfg = w2v_ssl or SSLConfig()
        trunk = init_random_(Wav2Vec2Model(scfg), gen)
        wcfg = whisper_cfg or WhisperConfig()
        wenc = init_random_(WhisperEncoder(wcfg), gen)
        wdec = init_random_(WhisperDecoder(wcfg), gen)
        hf_cfg = {"hidden_size": scfg.hidden_size,
                  "num_hidden_layers": scfg.num_layers,
                  "num_attention_heads": scfg.num_heads,
                  "intermediate_size": scfg.ffn_size,
                  "conv_dim": list(scfg.conv_dim),
                  "conv_kernel": list(scfg.conv_kernel),
                  "conv_stride": list(scfg.conv_stride),
                  "conv_bias": scfg.conv_bias,
                  "feat_extract_norm": scfg.feat_extract_norm,
                  "num_conv_pos_embeddings": scfg.num_conv_pos_embeddings,
                  "num_conv_pos_embedding_groups":
                      scfg.num_conv_pos_embedding_groups,
                  "do_stable_layer_norm": scfg.do_stable_layer_norm}
        wh_cfg = {"vocab_size": wcfg.vocab_size,
                  "num_mel_bins": wcfg.n_mels, "d_model": wcfg.d_model,
                  "encoder_layers": wcfg.encoder_layers,
                  "decoder_layers": wcfg.decoder_layers,
                  "encoder_attention_heads": wcfg.num_heads,
                  "encoder_ffn_dim": wcfg.ffn_size,
                  "max_source_positions": wcfg.max_source_positions,
                  "max_target_positions": wcfg.max_target_positions}
        cases = (
            ("wav2vec2", hf_wav2vec2_state(trunk), np.float32, hf_cfg,
             "params:encoder/upstream",
             ["--model.encoder_type", "wav2vec2", "--model.ssl",
              json.dumps(dataclasses_dict(scfg))],
             {k: v for k, v in trunk.state_dict().items()},
             lambda model: model.encoder.upstream, CTC),
            ("whisper", hf_whisper_state(wenc, wdec), np.float16, wh_cfg,
             "encoder:encoder",
             ["--model.encoder_type", "whisper", "--model.decoder_type",
              "whisper", "--model.ctc_weight", "0.0", "--model.whisper",
              json.dumps(dataclasses_dict(wcfg))],
             {k: v for k, v in wenc.state_dict().items()},
             lambda model: model.encoder, {}))
        for kind, sd, dt, conf, spec, model_args, src, part, per in cases:
            d = ws / f"hf_{kind}"
            d.mkdir()
            t = time.perf_counter()
            write_safetensors(d / "model.safetensors",
                              {k: np.ascontiguousarray(v, dt)
                               for k, v in sd.items()})
            (d / "config.json").write_text(json.dumps(conf))
            out = ws / f"{kind}.msgpack"
            convert_hf.main(["--model_type", kind, "--checkpoint", str(d),
                             "--out", str(out)])
            n_leaves = len(flatten(load_tree(out)))
            size = (d / "model.safetensors").stat().st_size / 2 ** 20
            conv_s = time.perf_counter() - t
            aexp = ws / f"{kind}_asr"
            (_, trainer, model, _, _), counts, wall = counted_call(
                asr_train.main, [
                    *common, "--optim.lr", "0.0", "--data.train_dir",
                    str(ws / "data"), "--data.batch_size", "8",
                    "--model.normalize", "utterance_mvn",
                    "--model.use_specaug", "false", "--run.init_param",
                    f"{out}:{spec}", "--run.output_dir", str(aexp),
                    *model_args, *asr_args, *dev])
            got = part(model).state_dict()
            worst, off = 0.0, []
            for k, v in src.items():
                want = v.detach().cpu().to(getattr(torch, np.dtype(
                    dt).name)).float()
                g = got[k].detach().cpu().float()
                rel = float((g - want).abs().max()
                            / want.abs().max().clamp(min=1e-30))
                worst = max(worst, rel)
                if rel > (WEIGHT_NORM_RTOL if k == "pos_conv.weight"
                          else 0.0):
                    off.append((k, rel))
            n_steps = len(trainer.step_log)
            check_launches(f"asr_train {kind}", counts, expected_counts(
                per if on_card else {}, n_steps))
            log("ssl", f"bin.convert_hf {kind}: {size:.0f} MiB "
                f"{np.dtype(dt).name} safetensors -> {n_leaves} leaves, "
                f"{conv_s:.1f}s; bin.asr_train --run.init_param {spec}: "
                f"{len(src)} tensors equal to the source (the weight-norm "
                f"conv within {WEIGHT_NORM_RTOL}: worst relative "
                f"difference {worst:.2e}), {n_steps} steps, {wall:.1f}s; "
                f"launches exact [{smi}]")
            if off:
                raise AssertionError(f"asr_train {kind}: the transferred "
                                     f"weights differ from the source: {off}")
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def dataclasses_dict(cfg):
    """A model section's fields but dtype, as the CLI's YAML flow map."""
    import dataclasses

    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def phase_ssl(torch, np, smi):
    """The SSL and Whisper parts and HuBERT: the kernels at HuBERT's shapes,
    ssl_conformer, wav2vec2_ctc and whisper_base served and trained,
    hubert_pretrain trained, then the CLIs. Returns hubert_pretrain's
    timed steps' launches."""
    t0 = time.perf_counter()
    ssl_kernels(torch, np)
    ssl_case(torch, np, smi, "ssl_conformer")
    ssl_case(torch, np, smi, "wav2vec2_ctc")
    ssl_case(torch, np, smi, "whisper_base")
    launches = ssl_hubert(torch, np, smi)
    ssl_clis(torch, np, smi)
    log("ssl", f"phase {time.perf_counter() - t0:.1f}s")
    return launches


# the tts phase: FastSpeech2, Tacotron2, Transformer-TTS and ProDiff at the
# JAX configs' widths (`configs.tts_config`), then the TTS CLIs and run_tts
TTS_TYPES = ("fastspeech2", "tacotron2", "transformer", "prodiff")
TTS_BATCH, TTS_SECONDS, TTS_TOKENS = 32, 10.0, 120  # 626 mel frames
TTS_REQUESTS = 4  # of TTS_TOKENS tokens, vocoded by Griffin-Lim
TTS_GL_ITERS = 32
TTS_TIMED_STEPS = {"fastspeech2": 3, "tacotron2": 1, "transformer": 3,
                   "prodiff": 3}
# random weights fire the stop token at once: the served autoregressive
# models run with it off, to the TTS_AR_FRAMES cap
TTS_NO_STOP = 1.1
# kernel launches of one synthesis call (the encoder stacks, and
# FastSpeech2's decoder over max_frames) and of one train step
TTS_PER_SERVE = {
    "fastspeech2": {"flash_attention": 8, "prenorm_ffn": 8},
    "tacotron2": {},
    "transformer": {"flash_attention": 6, "prenorm_ffn": 6},
    "prodiff": {"flash_attention": 4, "prenorm_ffn": 4},
}
TTS_PER_STEP = {k: {**v, "prenorm_ffn_bwd": v.get("prenorm_ffn", 0)}
                if v else {} for k, v in TTS_PER_SERVE.items()}
TTS_MEL_FP32_TOL = 1e-3  # kernels vs plain synthesis, float32
# the float32 comparison of the autoregressive two stops at this many
# frames: each frame feeds the next, so the two routes' last-bit
# differences in the encoder grow along the loop (1.3e-3 after 400
# Transformer-TTS frames on an H100)
TTS_FP32_AR_FRAMES = 64
# run_tts's Tacotron2: the recipe's plumbing, at a width that keeps its
# subprocesses' checkpoints small
TTS_RECIPE_TACO = ("--model.tacotron2.embed_dim", "64",
                   "--model.tacotron2.encoder_conv_channels", "64",
                   "--model.tacotron2.encoder_lstm_units", "64",
                   "--model.tacotron2.decoder_lstm_units", "128",
                   "--model.tacotron2.postnet_channels", "64")
TTS_CLI_UTTS = 8


def tts_model(torch, cfg, seed=0):
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.tts.model import TTSModel

    return init_random_(TTSModel(cfg), torch.Generator().manual_seed(seed))


def tts_sub(cfg):
    """The model configuration inside a TTSTaskConfig."""
    return getattr(cfg, cfg.tts_type)


def tts_replace(cfg, **kw):
    """`cfg` with fields of its model configuration replaced."""
    import dataclasses

    return dataclasses.replace(cfg, **{cfg.tts_type: dataclasses.replace(
        tts_sub(cfg), **kw)})


def tts_batch(np, cfg, b, seconds, tokens, seed):
    """Seeded noise waveforms of `seconds` with `tokens` random token ids;
    durations that fill the mel frames (FastSpeech2, ProDiff)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    frames = n // cfg.hop_length + 1
    dur = np.full((b, tokens), frames // tokens, np.int32)
    dur[:, 0] += frames - dur.sum(1)
    return {"text": rng.randint(1, cfg.vocab_size - 1, (b, tokens)
                                ).astype(np.int32),
            "text_lengths": np.full((b,), tokens, np.int32),
            "speech": (0.1 * rng.randn(b, n)).astype(np.float32),
            "speech_lengths": np.full((b,), n, np.int32),
            "durations": dur}


def tts_keys(cfg):
    from espnet_tpu_torch.tasks.tts import batch_keys

    return batch_keys(cfg.tts_type)


def tts_kernels(torch, np):
    """Flash attention at FastSpeech2's head dim 192 (B=32, H=2, T=626
    ragged: its training shape; B=4, T=2048: its decoder at inference) and
    the pre-norm FFN at D=384, F=1536 and B x 626 rows, float32 and bf16,
    against their plain versions, SDPA with the key mask beside flash.
    Returns the bf16 training-shape flash result (the kernels line's D=192
    row)."""
    import types

    import torch.nn.functional as F

    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)

    frames = int(TTS_SECONDS * SAMPLE_RATE) // 256 + 1
    cases = [(TTS_BATCH, frames, [frames - (i % 9) * 37
                                  for i in range(TTS_BATCH)], "train"),
             (TTS_REQUESTS, 2048, [2048, 1400, 700, 150], "inference")]
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, t, lengths, role in cases:
            args, flops, nbytes, valid = flash_case(torch, b, t, dtype,
                                                    lengths, 51, h=2, d=192)
            label = f"fastspeech2 {role} B={b} H=2 T={t} D=192"
            with torch.no_grad():
                fa = check_kernel(torch, "flash_attention", flash_attention,
                                  flash_attention_plain, args, flops, nbytes,
                                  dn, label, iters=10)
                fa["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        *args[:3], attn_mask=valid), 10)
            log("kernels", f"flash_attention {label} {dn}: library "
                f"(scaled_dot_product_attention, boolean key mask) "
                f"{fa['library_ms']:.4f} ms")
            if role == "train" and dtype == torch.bfloat16:
                main = fa
            del args
    fs2 = types.SimpleNamespace(d_model=384, d_ff=1536, dropout_rate=0.1)
    check_ffn_rows(torch, fs2, TTS_BATCH * frames,
                   f"fastspeech2 M={TTS_BATCH}x{frames}", "relu", 1.0)
    return main


def tts_requests(np, cfg):
    rng = np.random.RandomState(7)
    text = rng.randint(1, cfg.vocab_size - 1, (TTS_REQUESTS, TTS_TOKENS))
    return text, np.full((TTS_REQUESTS,), TTS_TOKENS)


def tts_serve(torch, np, smi, cfg, device="cuda", gl_iters=TTS_GL_ITERS):
    """Synthesise the requests in bf16 and vocode them with Griffin-Lim:
    wall, RTF (over the seconds synthesised), exact launches; then the
    float32 synthesis with kernels against plain (same lengths, mels
    within TTS_MEL_FP32_TOL)."""
    from espnet_tpu_torch.ops.griffin_lim import logmel_to_wav

    name = cfg.tts_type
    if name in ("tacotron2", "transformer"):
        cfg = tts_replace(cfg, stop_threshold=TTS_NO_STOP)
    per = TTS_PER_SERVE[name] if device == "cuda" else {}
    text, lens = tts_requests(np, cfg)
    tt = torch.from_numpy(text).to(device)
    tl = torch.from_numpy(lens).to(device)
    model = tts_model(torch, cfg).to(device).eval()

    def synth(m, max_frames=None):
        return m.inference(tt, tl, max_frames,
                           generator=torch.Generator().manual_seed(2))

    synth(model)  # warm-up
    sync(torch, device)
    wrappers = reset_counts()
    t = time.perf_counter()
    mel, mlens = synth(model)
    sync(torch, device)
    t_mel = time.perf_counter() - t
    counts = {n: fn.launches for n, fn in wrappers.items()}
    t = time.perf_counter()
    wav = logmel_to_wav(mel.float(), cfg.fs, cfg.n_fft, cfg.hop_length,
                        cfg.win_length, cfg.n_mels, gl_iters)
    sync(torch, device)
    t_gl = time.perf_counter() - t
    check_case_launches(name, "one synthesis", counts, per, 1)
    if not (torch.isfinite(mel.float()).all() and torch.isfinite(wav).all()):
        raise AssertionError(f"{name}: non-finite mel or wave")
    seconds = float(mlens.sum()) * cfg.hop_length / cfg.fs
    padded = mel.shape[0] * mel.shape[1] * cfg.hop_length / cfg.fs
    log("tts", f"{name} serve {tts_sub(cfg).dtype}: {TTS_REQUESTS} x "
        f"{TTS_TOKENS} tokens -> mel {tuple(mel.shape)}, lengths "
        f"{mlens.tolist()} ({seconds:.2f} s of speech, {padded:.2f} s "
        f"padded); acoustic model {t_mel:.3f}s, Griffin-Lim ({gl_iters} "
        f"iterations, the padded mel) {t_gl:.3f}s; RTF "
        f"{(t_mel + t_gl) / max(seconds, 1e-9):.4f} over the speech, "
        f"{(t_mel + t_gl) / padded:.4f} over the padded mel [{smi}]; "
        f"launches exact {({k: v for k, v in counts.items() if v})}")
    m32 = tts_model(torch, tts_replace(cfg, dtype=torch.float32))
    m32 = m32.to(device).eval()
    frames = TTS_FP32_AR_FRAMES if name in ("tacotron2", "transformer") \
        else None
    got, glen = synth(m32, frames)
    m32.set_use_kernels(False)
    want, wlen = synth(m32, frames)
    sync(torch, device)
    dev = float((got - want).abs().max()) if glen.equal(wlen) else None
    log("tts", f"{name} serve float32 kernels vs plain "
        f"({tuple(got.shape)}): lengths equal {glen.equal(wlen)}, max |dev| "
        f"{'-' if dev is None else f'{dev:.3e}'} (limit {TTS_MEL_FP32_TOL})")
    if dev is None or dev > TTS_MEL_FP32_TOL:
        raise AssertionError(f"{name}: the kernel route's synthesis differs "
                             "from the plain route's")


def tts_train_parity(torch, np, cfg, device="cuda", batch_size=4,
                     seconds=3.0):
    """One float32 forward and backward at full width with the kernels and
    with their plain versions (dropout 0; the postnet's and predictors'
    fixed dropouts, zoneout and ProDiff's draws from one seed on both
    routes): same loss, same gradients."""
    cfg = tts_replace(cfg, dtype=torch.float32, dropout_rate=0.0)
    model = tts_model(torch, cfg, seed=1).to(device).train()
    batch = tts_batch(np, cfg, batch_size, seconds, TTS_TOKENS // 2, 3)
    args = [torch.from_numpy(batch[k]).to(device) for k in tts_keys(cfg)]
    params = list(model.parameters())
    out = {}
    for use in (True, False):
        model.set_use_kernels(use)
        loss, _ = model(*args, generator=torch.Generator().manual_seed(5))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[use] = (float(loss.detach()), [g for g in grads])
    model.set_use_kernels(True)
    sync(torch, device)
    (lk, gk), (lp, gp) = out[True], out[False]
    pairs = [(a, b) for a, b in zip(gk, gp) if b is not None]
    total = float(torch.sqrt(sum((b.double() ** 2).sum() for _, b in pairs)))
    whole = float(torch.sqrt(sum(((a.double() - b.double()) ** 2).sum()
                                 for a, b in pairs))) / total
    loss_dev = abs(lk - lp) / abs(lp)
    log("tts", f"{cfg.tts_type} train-parity float32 B={batch_size} x "
        f"{seconds} s: loss kernels {lk:.6f} vs plain {lp:.6f} (relative "
        f"{loss_dev:.2e}, limit {TRAIN_FP32_LOSS_RTOL}); gradient relative "
        f"L2 {whole:.2e} (limit {TRAIN_FP32_GRAD_REL_L2})")
    if not (np.isfinite(lk) and np.isfinite(whole)) or \
            loss_dev > TRAIN_FP32_LOSS_RTOL or \
            whole > TRAIN_FP32_GRAD_REL_L2:
        raise AssertionError(f"{cfg.tts_type}: the float32 train step with "
                             "kernels deviates from the plain versions'")


def tts_train(torch, np, smi, cfg, device="cuda", batch_size=TTS_BATCH,
              seconds=TTS_SECONDS, tokens=TTS_TOKENS, steps=None):
    """The training run through make_train_step (bf16, dropout as
    configured, adam with warmuplr): 1 warm-up step, then the timed steps
    with their exact launches. Returns the timed steps' launches."""
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    name = cfg.tts_type
    steps = steps or TTS_TIMED_STEPS[name]
    model = tts_model(torch, cfg)
    keys = tts_keys(cfg)
    tx = build_optimizer("fused_adam", lr=1e-3, schedule="warmuplr",
                         warmup_steps=4000, d_model=256)
    step = make_train_step(model, tx, device=device, batch_keys=keys)
    state = TrainState.create(model, tx)
    batch = {k: torch.from_numpy(v).to(device) for k, v in tts_batch(
        np, cfg, batch_size, seconds, tokens, 0).items()}
    gen = torch.Generator().manual_seed(0)
    t = time.perf_counter()
    state, stats = step(state, batch, gen)
    sync(torch, device)
    warm = time.perf_counter() - t
    before = state.params.clone()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    all_stats = []
    for _ in range(steps):
        state, stats = step(state, batch, gen)
        all_stats.append({k: float(v) for k, v in stats.items()})
    sync(torch, device)
    step_s = (time.perf_counter() - t) / steps
    counts = {n: fn.launches for n, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else float("nan"))
    for i, st in enumerate(all_stats):
        if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])):
            raise AssertionError(f"{name} train step {i + 1}: non-finite")
        if st["skipped"] != 0.0:
            raise AssertionError(f"{name} train step {i + 1} was skipped")
    if not float((state.params - before).abs().max()) > 0.0:
        raise AssertionError(f"{name}: the train steps did not move the "
                             "parameters")
    check_case_launches(name, f"{steps} train steps", counts,
                        TTS_PER_STEP[name] if device == "cuda" else {},
                        steps)
    n_params = sum(p.numel() for p in model.parameters())
    log("tts", f"{name} train {tts_sub(cfg).dtype} ({n_params} parameters) "
        f"B={batch_size} x {seconds} s, {tokens} tokens: warm-up "
        f"{warm:.2f}s, {step_s * 1e3:.1f} ms/step over {steps}, "
        f"{batch_size * seconds / step_s:.1f} audio-s/s, peak {peak:.2f} "
        f"GiB [{smi}]; loss {all_stats[-1]['loss']:.4f}; launches exact "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


def tts_clis(torch, np, smi, device="cuda", taco_args=TTS_RECIPE_TACO,
             fs2_args=()):
    """The CLIs on a synthetic corpus of TTS_CLI_UTTS utterances: `run_tts`
    (stages 1-9 for a Tacotron2 of `taco_args`; subprocesses with their
    launch logs), then in process the teacher flow from the Tacotron2 it
    trained: `tts_teacher_durations`, `tts_train` of a FastSpeech2 of
    `fs2_args` on those durations, its `tts_inference` and `tts_scoring`.
    Every launch count exact."""
    import json
    import os
    import shlex
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import (tts_inference, tts_scoring,
                                      tts_teacher_durations, tts_train)
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.ops.launches import LAUNCH_LOG_ENV

    dev = ["--device", device]
    ws = Path(tempfile.mkdtemp(prefix="tts_cli_"))
    train, test = ws / "data" / "train", ws / "data" / "test"
    generate_corpus(train, n_utts=TTS_CLI_UTTS, min_words=2, max_words=4)
    generate_corpus(test, n_utts=2, min_words=2, max_words=3, seed=5)
    run = ["--run.max_epoch", "1", "--run.log_interval", "1000",
           "--optim.schedule", "constant", "--optim.lr", "0.001",
           "--data.batch_size", str(TTS_CLI_UTTS)]

    log_file = ws / "launches.jsonl"
    env = dict(os.environ, **{LAUNCH_LOG_ENV: str(log_file)})
    cmd = [sys.executable, "-m", "espnet_tpu_torch.bin.run_tts",
           "--recipe.expdir", str(ws / "exp"),
           "--recipe.datadir", str(ws / "data"), "--recipe.local_data", "",
           "--recipe.tts_type", "tacotron2",
           "--recipe.tts_args", shlex.join(list(run) + list(taco_args)),
           "--recipe.synth_args",
           "--max_frames 128 --griffin_lim_iters 8 --batch_size 2", *dev]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-8000:], flush=True)
        raise AssertionError(f"run_tts exited {proc.returncode}")
    for n in range(1, 10):
        if not (ws / "exp" / f".stage{n}.done").exists():
            raise AssertionError(f"run_tts: stage {n} not done")
    logged = [json.loads(x) for x in log_file.read_text().splitlines()]
    for entry in logged:
        check_case_launches(entry["cli"], "its run", entry["launches"], {},
                            1)
    clis = sorted(e["cli"] for e in logged)
    if clis != ["tts_inference", "tts_train"]:
        raise AssertionError(f"run_tts: launch logs of {clis}")
    score = (ws / "exp" / "score_test" / "score_mcd.txt").read_text()
    log("tts", f"cli run_tts tacotron2 (stages 1-9): {wall:.1f}s; "
        f"{score.splitlines()[0]}; launch logs of {clis}, none launched "
        f"(exact) [{smi}]")

    layers = 2 if device == "cuda" else 0
    step = {"flash_attention": 2 * layers, "prenorm_ffn": 2 * layers,
            "prenorm_ffn_bwd": 2 * layers}
    synth = {"flash_attention": 2 * layers, "prenorm_ffn": 2 * layers}
    calls = [
        ("tts_teacher_durations", tts_teacher_durations.main, [
            "--exp_dir", str(ws / "exp" / "tts"), "--data_dir", str(train),
            *dev], {}),
        ("tts_train fastspeech2", tts_train.main, [
            "--run.output_dir", str(ws / "fs2"), "--data.train_dir",
            str(train), "--model.tts_type", "fastspeech2", *run, *fs2_args,
            *dev], step),
        ("tts_inference fastspeech2", tts_inference.main, [
            "--exp_dir", str(ws / "fs2"), "--data_dir", str(test),
            "--output_dir", str(ws / "synth"), "--griffin_lim_iters", "8",
            *dev], synth),
        ("tts_scoring", tts_scoring.main, [
            "--ref_dir", str(test), "--synth_dir", str(ws / "synth"),
            "--output_dir", str(ws / "score")], {}),
    ]
    for what, fn, argv, per in calls:
        _, counts, wall = counted_call(fn, argv)
        check_case_launches(what, "its run", counts, per, 1)
        log("tts", f"cli {what}: {wall:.1f}s; launches exact "
            f"{({k: v for k, v in counts.items() if v})}")
    durs = (train / "durations").read_text().splitlines()
    if len(durs) != TTS_CLI_UTTS:
        raise AssertionError("tts_teacher_durations wrote no durations")
    log("tts", f"cli MCD of the FastSpeech2 synthesis: "
        f"{(ws / 'score' / 'score_mcd.txt').read_text().splitlines()[0]}")


TTS_FS2_CLI = ("--model.fastspeech2.encoder_layers", "2",
               "--model.fastspeech2.decoder_layers", "2")


def phase_tts(torch, np, smi):
    """The TTS slice: flash at head dim 192 and the pre-norm FFN at
    FastSpeech2's shapes; each of the four configurations served (Griffin-
    Lim) and trained, with its float32 kernel route against the plain
    route and its exact launches; then the CLIs and run_tts. Returns (the
    D=192 flash row's result, FastSpeech2's timed steps' launches)."""
    from espnet_tpu_torch.configs import tts_config

    t0 = time.perf_counter()
    flash192 = tts_kernels(torch, np)
    launches = {}
    for name in TTS_TYPES:
        cfg = tts_config(torch.bfloat16, name)
        tts_serve(torch, np, smi, cfg)
        tts_train_parity(torch, np, cfg)
        launches[name] = tts_train(torch, np, smi, cfg)
    tts_clis(torch, np, smi, fs2_args=TTS_FS2_CLI)
    log("tts", f"phase {time.perf_counter() - t0:.1f}s")
    return flash192, launches["fastspeech2"]


GAN_BATCH, GAN_SEGMENT = 16, 8192  # HiFiGAN's published batch and crop
GAN_VOCODERS = ("hifigan", "melgan", "multiband_melgan", "parallel_wavegan",
                "style_melgan")
GAN_TIMED_STEPS = {"hifigan": 2, "melgan": 1, "multiband_melgan": 1,
                   "parallel_wavegan": 1, "style_melgan": 1, "vits": 2,
                   "jets": 2}
GAN_TTS_BATCH, GAN_TTS_SECONDS, GAN_TTS_TOKENS = 16, 10.0, 120
GAN_REQUESTS = 4  # of GAN_TTS_TOKENS tokens
GAN_VOCAB = 40
# kernel launches of one train step and of one synthesis call: VITS's six
# text-encoder layers (flash at head dim 96; the FFN at D=192 fails the
# kernels' tile gate, as in JAX), JETS's 4 + 4 FFT layers (flash at head
# dim 128, the pre-norm FFN at D=256, F=1024) and its forward-sum CTC
GAN_PER_STEP = {"vits": {"flash_attention": 6},
                "jets": {"flash_attention": 8, "prenorm_ffn": 8,
                         "prenorm_ffn_bwd": 8, **CTC}}
GAN_PER_SYNTH = {"vits": {"flash_attention": 6},
                 "jets": {"flash_attention": 8, "prenorm_ffn": 8}}
GAN_FP32_TOL = 1e-3  # the text stacks, kernels vs plain, float32
GAN_CLI_UTTS = 8


def gan_text_batch(np, b, seconds, tokens, vocab, seed, hop=256):
    """B ragged utterances of seeded noise (whole hops, up to `seconds`)
    and random token ids (up to `tokens`), as numpy."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    n -= n % hop
    wlens = np.array([n - (i % 4) * 40 * hop for i in range(b)], np.int64)
    tlens = np.array([tokens - (i % 5) for i in range(b)], np.int64)
    wav = (0.1 * rng.randn(b, n)).astype(np.float32)
    wav[np.arange(n)[None, :] >= wlens[:, None]] = 0.0
    text = rng.randint(1, vocab - 1, (b, tokens)).astype(np.int64)
    text[np.arange(tokens)[None, :] >= tlens[:, None]] = 0
    return text, tlens, wav, wlens


def jets_lattice(torch, np, b, t, u, seed):
    """The forward-sum lattice of JETS at B utterances of T frames and U
    tokens (S = 2U + 1): log-probs (B, T, U + 1) of a random alignment with
    the weak blank prepended, labels 1..U, lengths, and the pair's inputs."""
    from espnet_tpu_torch.ops import ctc as tctc

    rng = np.random.RandomState(seed)
    att = torch.log_softmax(torch.from_numpy(
        rng.randn(b, t, u).astype(np.float32)).cuda(), -1)
    blank = torch.full((b, t, 1), -4.0, device="cuda")
    lp = torch.log_softmax(torch.cat([blank, att], -1), -1)
    labels = torch.arange(1, u + 1, device="cuda")[None].expand(b, u)
    in_lens = torch.tensor([t - (i % 4) * 40 for i in range(b)]).cuda()
    lab_lens = torch.tensor([u - (i % 5) for i in range(b)]).cuda()
    ext = tctc.extended_labels(labels)
    emit = lp.gather(2, ext[:, None, :].expand(b, t, ext.shape[1])
                     ).transpose(0, 1).contiguous()
    return lp, labels, in_lens, lab_lens, emit, tctc.transition_mask(ext)


def gan_kernels(torch, np):
    """The kernels at this slice's shapes against their plain versions:
    flash at VITS's head dim 96 (zero-padded to 128; B=16, H=2, T=120
    ragged) and JETS's 128 (its encoder's T=120 and decoder's T=626), with
    SDPA beside each; the pre-norm FFN at D=256, F=1024 on 16 x 626 rows
    (relu, residual 1.0, dropout 0.1); the CTC pair on JETS's forward-sum
    lattice at 120 tokens (S=241: a warp per utterance) and 200 (S=401: a
    block per utterance), with torch's ctc_loss beside it. Returns the
    bf16 VITS flash result (the kernels line's `flash_attention_d96`)."""
    import types

    import torch.nn.functional as F

    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)

    frames = int(GAN_TTS_SECONDS * SAMPLE_RATE) // 256 + 1
    tok = GAN_TTS_TOKENS
    cases = [("vits text encoder", GAN_TTS_BATCH, tok, 96),
             ("jets encoder", GAN_TTS_BATCH, tok, 128),
             ("jets decoder", GAN_TTS_BATCH, frames, 128)]
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for role, b, t, d in cases:
            lengths = [t - (i % 5) * (t // 10) for i in range(b)]
            args, flops, nbytes, valid = flash_case(torch, b, t, dtype,
                                                    lengths, 61, h=2, d=d)
            label = f"{role} B={b} H=2 T={t} D={d}"
            with torch.no_grad():
                fa = check_kernel(torch, "flash_attention", flash_attention,
                                  flash_attention_plain, args, flops, nbytes,
                                  dn, label, iters=10)
                fa["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        *args[:3], attn_mask=valid), 10)
            log("kernels", f"flash_attention {label} {dn}: library "
                f"(scaled_dot_product_attention, boolean key mask) "
                f"{fa['library_ms']:.4f} ms")
            if d == 96 and dtype == torch.bfloat16:
                main = fa
            del args
    jets = types.SimpleNamespace(d_model=256, d_ff=1024, dropout_rate=0.1)
    check_ffn_rows(torch, jets, GAN_TTS_BATCH * frames,
                   f"jets M={GAN_TTS_BATCH}x{frames}", "relu", 1.0)
    for u in (tok, 200):
        lp, labels, in_lens, lab_lens, emit, skip = jets_lattice(
            torch, np, GAN_TTS_BATCH, frames, u, 62)
        lpt = lp.transpose(0, 1).detach().requires_grad_(True)
        lib = F.ctc_loss(lpt, labels, in_lens, lab_lens, blank=0,
                         reduction="sum", zero_infinity=True)
        lib_fwd = time_ms(torch, lambda: F.ctc_loss(
            lpt, labels, in_lens, lab_lens, blank=0, reduction="sum",
            zero_infinity=True), 10)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib, lpt, retain_graph=True), 10)
        check_ctc_pair(torch, emit, skip, in_lens, lab_lens,
                       f"jets forward-sum B={GAN_TTS_BATCH} T={frames} "
                       f"U={u} S={2 * u + 1}", (lib_fwd, lib_bwd))
    return main


def gan_timed(torch, np, smi, name, state, step_once, per_step, steps,
              device="cuda"):
    """One warm-up step, then `steps` timed ones with their exact launches
    and peak memory; every loss finite and both modules moved. Returns
    (ms a step, peak GiB, the last stats, the timed steps' launches)."""
    step_once()
    sync(torch, device)
    before = (state.gen_flat.clone(), state.disc_flat.clone())
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    all_stats = [{k: float(v) for k, v in step_once().items()}
                 for _ in range(steps)]
    sync(torch, device)
    ms = (time.perf_counter() - t) / steps * 1e3
    counts = {n: fn.launches for n, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else float("nan"))
    for i, st in enumerate(all_stats):
        bad = [k for k, v in st.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} step {i + 1}: {bad} not finite")
    for what, old, new in (("generator", before[0], state.gen_flat),
                           ("discriminator", before[1], state.disc_flat)):
        if not float((new - old).abs().max()) > 0.0:
            raise AssertionError(f"{name}: the {what} did not move")
    check_case_launches(name, f"{steps} train steps", counts,
                        per_step if device == "cuda" else {}, steps)
    return ms, peak, all_stats[-1], counts


def gan_vocoder(torch, np, smi, gtype, device="cuda", batch=GAN_BATCH,
                segment=GAN_SEGMENT, model=None):
    """A vocoder train step at the task's defaults (`model`: a
    VocoderModelConfig to use instead): B crops of `segment` samples of
    seeded noise, their log-mel, the GAN step with both optimizers."""
    import dataclasses

    from espnet_tpu_torch.ops.stft import log_mel_spectrogram
    from espnet_tpu_torch.tasks.vocoder import (VocoderDataConfig,
                                                VocoderModelConfig,
                                                VocoderOptimConfig,
                                                VocoderTask, gan_state)
    from espnet_tpu_torch.train.gan_steps import (GANLossWeights,
                                                  make_gan_train_step)

    data = VocoderDataConfig()
    mc = model or dataclasses.replace(VocoderModelConfig(),
                                      generator_type=gtype)
    gen, disc = VocoderTask.build_models(mc, data.n_mels)
    state = gan_state(gen, disc, VocoderOptimConfig(), 0, device)
    rng = np.random.RandomState(3)
    wav = torch.from_numpy((0.1 * rng.randn(batch, segment)).astype(
        np.float32)).to(device)
    lens = torch.full((batch,), segment, device=device)
    mel = log_mel_spectrogram(wav, lens, data.fs, data.n_fft, data.hop_length,
                              None, data.n_mels)[0][:, :segment
                                                    // data.hop_length]
    step = make_gan_train_step(GANLossWeights(
        feat_match=mc.lambda_feat_match, mel=mc.lambda_mel,
        stft=mc.lambda_stft, n_fft=data.n_fft, hop_length=data.hop_length,
        n_mels=data.n_mels))
    ms, peak, st, _ = gan_timed(torch, np, smi, gtype, state,
                                lambda: step(state, mel, wav), {},
                                GAN_TIMED_STEPS.get(gtype, 1), device)
    n_g = sum(p.numel() for p in gen.parameters())
    n_d = sum(p.numel() for p in disc.parameters())
    log("gan", f"{gtype} train float32 (generator {n_g}, discriminator "
        f"{n_d} parameters) B={batch} x {segment} samples: {ms:.1f} ms/step,"
        f" peak {peak:.2f} GiB [{smi}]; generator loss {st['loss']:.4f}, "
        f"discriminator {st['discriminator_loss']:.4f}; no kernel (exact)")
    return ms


def gan_tts_model(torch, family, vocab, device, **overrides):
    """(generator, discriminator) of the JAX defaults (VITSConfig /
    JETSConfig, the HiFiGAN multi discriminator), overridden."""
    from espnet_tpu_torch.models.tts.hifigan import HiFiGANMultiDiscriminator
    from espnet_tpu_torch.models.tts.jets import JETSConfig, JETSGenerator
    from espnet_tpu_torch.models.tts.vits import VITSConfig, VITSGenerator

    if family == "vits":
        gen = VITSGenerator(VITSConfig(vocab_size=vocab, **overrides))
    else:
        gen = JETSGenerator(JETSConfig(vocab_size=vocab, **overrides))
    return gen, HiFiGANMultiDiscriminator()


def gan_tts(torch, np, smi, family, device="cuda", batch=GAN_TTS_BATCH,
            seconds=GAN_TTS_SECONDS, tokens=GAN_TTS_TOKENS, overrides=None,
            requests=GAN_REQUESTS):
    """VITS or JETS at the JAX defaults: the float32 text stack with
    kernels against plain, the train step (timed, exact launches, peak
    memory), then the synthesis of `requests` texts (wall, exact
    launches, finite waves). Returns the timed steps' launches."""
    from espnet_tpu_torch.tasks.jets import JETSDataConfig, jets_features
    from espnet_tpu_torch.tasks.vits import linear_spectrogram
    from espnet_tpu_torch.tasks.vocoder import VocoderOptimConfig, gan_state
    from espnet_tpu_torch.train.gan_steps import (make_jets_train_step,
                                                  make_vits_train_step)

    overrides = overrides or {}
    gen, disc = gan_tts_model(torch, family, GAN_VOCAB, device, **overrides)
    state = gan_state(gen, disc, VocoderOptimConfig(), 0, device)
    text, tlens, wav, wlens = (torch.from_numpy(a).to(device) for a in
                               gan_text_batch(np, batch, seconds, tokens,
                                              GAN_VOCAB, 5))
    hop = gen.upsample_factor
    if family == "vits":
        spec = linear_spectrogram(wav, gen.config.n_fft, hop)
        step = make_vits_train_step(hop_length=hop, upsample=hop)
        args = (text, tlens, spec, wlens // hop + 1, wav)
        stack = gen.text_encoder
    else:
        feats, flens, pitch, energy = jets_features(wav, wlens,
                                                    JETSDataConfig())
        step = make_jets_train_step(hop_length=hop)
        args = (text, tlens, feats, flens, pitch, energy, wav)
        stack = gen.encoder
    # the text stack in float32, kernels against plain
    gen.eval()
    with torch.no_grad():
        outs = []
        for use in (True, False):
            gen.set_use_kernels(use)
            outs.append(stack(text, tlens)[0] if family == "vits"
                        else stack(gen._embed(text), tlens))
    gen.set_use_kernels(True)
    gen.train()
    err = float((outs[0] - outs[1]).abs().max())
    if not err <= GAN_FP32_TOL:
        raise AssertionError(f"{family}: text stack kernels vs plain "
                             f"{err:.3e} (limit {GAN_FP32_TOL})")
    ms, peak, st, train_counts = gan_timed(
        torch, np, smi, family, state, lambda: step(state, *args),
        GAN_PER_STEP[family], GAN_TIMED_STEPS[family], device)
    n_g = sum(p.numel() for p in gen.parameters())
    log("gan", f"{family} train float32 ({n_g} generator parameters) "
        f"B={batch} x {seconds} s, {tokens} tokens: {ms:.1f} ms/step, "
        f"{batch * seconds / ms * 1e3:.1f} audio-s/s, peak {peak:.2f} GiB "
        f"[{smi}]; generator loss {st['loss']:.4f}; text stack float32 "
        f"kernels vs plain max |err| {err:.3e}; launches exact "
        f"{({k: v for k, v in train_counts.items() if v})}")
    # synthesis
    gen.eval()
    rng = np.random.RandomState(7)
    req = torch.from_numpy(rng.randint(1, GAN_VOCAB - 1, (
        requests, tokens))).to(device)
    rlens = torch.full((requests,), tokens, device=device)
    call = ((lambda: gen.inference(req, rlens, generator=torch.Generator(
        device=device).manual_seed(7))) if family == "vits"
        else (lambda: gen.inference(req, rlens)))
    call()
    sync(torch, device)
    wrappers = reset_counts()
    t = time.perf_counter()
    wave, wave_lens = call()
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {n: fn.launches for n, fn in wrappers.items()}
    check_case_launches(family, "a synthesis", counts,
                        GAN_PER_SYNTH[family] if device == "cuda" else {}, 1)
    if not bool(torch.isfinite(wave).all()):
        raise AssertionError(f"{family}: synthesis not finite")
    secs = float(wave_lens.sum()) / SAMPLE_RATE
    log("gan", f"{family} synthesis of {requests} x {tokens} tokens: wall "
        f"{wall:.3f} s for {secs:.1f} s of speech (RTF "
        f"{wall / max(secs, 1e-9):.4f}) [{smi}]; launches exact "
        f"{({k: v for k, v in counts.items() if v})}")
    return train_counts


GAN_CLI_VOCODER = ("--model.channels", "128", "--data.batch_size", "4",
                   "--data.steps_per_epoch", "2", "--run.max_epoch", "1")
GAN_CLI_FS2 = ("--model.tts_type", "fastspeech2",
               "--model.fastspeech2.encoder_layers", "1",
               "--model.fastspeech2.decoder_layers", "1",
               "--run.max_epoch", "1", "--optim.schedule", "constant",
               "--optim.lr", "0.001", "--data.batch_size", "8")
GAN_CLI_TTS = ("--run.max_epoch", "1", "--data.batch_size", "4",
               "--data.steps_per_epoch", "2", "--data.max_seconds", "3",
               "--model.decoder_channels", "128")
GAN_CLI_VITS = GAN_CLI_TTS + ("--model.text_layers", "2",
                              "--model.posterior_layers", "4",
                              "--model.flows", "2")
GAN_CLI_JETS = GAN_CLI_TTS + ("--model.encoder_layers", "1",
                              "--model.decoder_layers", "1")


def even_durations(texts, wlens, hop=256):
    """A durations file's rows: each utterance's frames spread over its
    character tokens (FastSpeech2's training targets)."""
    from espnet_tpu_torch.data.tokenizer import build_tokenizer

    tok = build_tokenizer("char")
    rows = {}
    for k, text in texts.items():
        n = len(tok.text2tokens(text))
        frames = wlens[k] // hop + 1
        d = [frames // n] * n
        d[0] += frames - sum(d)
        rows[k] = " ".join(map(str, d))
    return rows


def gan_clis(torch, np, smi, device="cuda"):
    """The slice's CLIs on a synthetic corpus of GAN_CLI_UTTS utterances,
    in process, each with its exact launches: vocoder_train (HiFiGAN at
    128 channels), tts_train of a FastSpeech2 on even durations, its
    tts_inference through --vocoder_dir, vits_train / vits_inference and
    jets_train / jets_inference at reduced depth."""
    import tempfile
    from pathlib import Path

    from espnet_tpu_torch.bin import (jets_inference, jets_train,
                                      tts_inference, tts_train,
                                      vits_inference, vits_train,
                                      vocoder_train)
    from espnet_tpu_torch.data.fileio import (read_2column_text, read_wav,
                                              write_2column_text)
    from espnet_tpu_torch.data.synth import generate_corpus

    dev = ["--device", device]
    ws = Path(tempfile.mkdtemp(prefix="gan_cli_"))
    train, test = ws / "train", ws / "test"
    generate_corpus(train, n_utts=GAN_CLI_UTTS, min_words=2, max_words=4)
    generate_corpus(test, n_utts=2, min_words=2, max_words=3, seed=5)
    wlens = {k: len(read_wav(p)[0]) for k, p in
             read_2column_text(train / "wav.scp").items()}
    write_2column_text(train / "durations", even_durations(
        read_2column_text(train / "text"), wlens))
    on = device == "cuda"
    steps = 2  # --data.steps_per_epoch of the GAN CLIs
    calls = [
        ("vocoder_train hifigan", vocoder_train.main, [
            "--data.train_dir", str(train), "--run.output_dir",
            str(ws / "voc"), *GAN_CLI_VOCODER, *dev], {}),
        ("tts_train fastspeech2", tts_train.main, [
            "--data.train_dir", str(train), "--run.output_dir",
            str(ws / "fs2"), *GAN_CLI_FS2, *dev],
         {"flash_attention": 2, "prenorm_ffn": 2, "prenorm_ffn_bwd": 2}
         if on else {}),
        ("tts_inference --vocoder_dir", tts_inference.main, [
            "--exp_dir", str(ws / "fs2"), "--data_dir", str(test),
            "--output_dir", str(ws / "fs2_synth"), "--vocoder_dir",
            str(ws / "voc"), *dev],
         {"flash_attention": 2, "prenorm_ffn": 2} if on else {}),
        ("vits_train", vits_train.main, [
            "--data.train_dir", str(train), "--run.output_dir",
            str(ws / "vits"), *GAN_CLI_VITS, *dev],
         {"flash_attention": 2 * steps} if on else {}),
        ("vits_inference", vits_inference.main, [
            "--exp_dir", str(ws / "vits"), "--data_dir", str(test),
            "--output_dir", str(ws / "vits_synth"), *dev],
         {"flash_attention": 2} if on else {}),
        ("jets_train", jets_train.main, [
            "--data.train_dir", str(train), "--run.output_dir",
            str(ws / "jets"), *GAN_CLI_JETS, *dev],
         {"flash_attention": 2 * steps, "prenorm_ffn": 2 * steps,
          "prenorm_ffn_bwd": 2 * steps, "ctc_alphas": steps,
          "ctc_gamma": steps} if on else {}),
        ("jets_inference", jets_inference.main, [
            "--exp_dir", str(ws / "jets"), "--data_dir", str(test),
            "--output_dir", str(ws / "jets_synth"), *dev],
         {"flash_attention": 2, "prenorm_ffn": 2} if on else {}),
    ]
    for what, fn, argv, per in calls:
        _, counts, wall = counted_call(fn, argv)
        check_case_launches(what, "its run", counts, per, 1)
        log("gan", f"cli {what}: {wall:.1f}s; launches exact "
            f"{({k: v for k, v in counts.items() if v})}")
    for d in ("fs2_synth", "vits_synth", "jets_synth"):
        waves = [read_wav(p)[0] for p in sorted((ws / d / "wav").glob(
            "*.wav"))]
        if len(waves) != 2 or not all(np.isfinite(w).all() for w in waves):
            raise AssertionError(f"gan cli: {d} wrote {len(waves)} waves")
    for name in ("generator.msgpack", "discriminator.msgpack",
                 "checkpoint.pt"):
        if not (ws / "voc" / name).exists():
            raise AssertionError(f"vocoder_train wrote no {name}")


def phase_gan(torch, np, smi):
    """The GAN slice: the kernels at VITS's and JETS's shapes; the five
    vocoders' train steps at the task's defaults (HiFiGAN V1 at B=16 x
    8192 samples); VITS and JETS at the JAX defaults trained and served;
    the CLIs. Returns (the D=96 flash row's result, VITS's timed steps'
    launches)."""
    t0 = time.perf_counter()
    flash96 = gan_kernels(torch, np)
    for gtype in GAN_VOCODERS:
        gan_vocoder(torch, np, smi, gtype)
    launches = {f: gan_tts(torch, np, smi, f) for f in ("vits", "jets")}
    gan_clis(torch, np, smi)
    log("gan", f"phase {time.perf_counter() - t0:.1f}s")
    return flash96, launches["vits"]


# --- the enh phase: enhancement and separation (`models/enh/`) --------------

ENH_CHUNK = 32000  # the task's chunk_length: 2 s at 16 kHz
ENH_BATCH = 8  # the task's batch_size
ENH_T = (ENH_CHUNK - 20) // 10 + 1  # 3199 frames of the conv encoder
ENH_LAYERS = 4  # EnhConfig's trans_layers
ENH_SERVE_SECONDS = (4.0, 4.5, 5.0, 6.0)  # enh_inference's mixtures
ENH_TIMED_STEPS = 2
ENH_LOSS_RTOL = 1e-4  # float32 loss, kernels vs plain
ENH_GRAD_REL_L2 = 1e-3  # float32 gradients, kernels vs plain, per tensor
ENH_WAVE_TOL = 1e-3  # float32 separated waves, kernels vs plain (|w| < ~1)
# the key projection's bias has a gradient of exactly 0 (softmax is
# invariant to a shift along the keys): both routes give rounding noise,
# held to ENH_ZERO_GRAD_REL of the model's largest gradient entry
ZERO_GRAD_LEAVES = ("self_attn.k_proj.bias",)
ENH_ZERO_GRAD_REL = 1e-4
# launches of one train step (a forward and backward) of the separators
# with kernels at EnhConfig's defaults (4 layers), and of one forward
ENH_STEP = {
    "conformer": {"relpos_attention": ENH_LAYERS,
                  "relpos_attention_bwd": ENH_LAYERS,
                  "prenorm_ffn": 2 * ENH_LAYERS,
                  "prenorm_ffn_bwd": 2 * ENH_LAYERS},
    "conformer_conv_module": {"relpos_attention": ENH_LAYERS,
                              "relpos_attention_bwd": ENH_LAYERS,
                              "prenorm_ffn": 2 * ENH_LAYERS,
                              "prenorm_ffn_bwd": 2 * ENH_LAYERS,
                              "conv_module": ENH_LAYERS,
                              "conv_module_bwd": ENH_LAYERS},
    # flash has no backward kernel (the recompute is PyTorch)
    "transformer": {"flash_attention": ENH_LAYERS,
                    "prenorm_ffn": ENH_LAYERS,
                    "prenorm_ffn_bwd": ENH_LAYERS},
    "tcn": {},  # Conv-TasNet: cuDNN convs, no kernel of the port
}
ENH_ENCODE = {"relpos_attention": 1, "prenorm_ffn": 2}  # a conformer layer
# every other separator at reduced depth: (overrides, mic channels or 0)
ENH_OTHERS = {
    "dprnn": (dict(dprnn_blocks=1), 0),
    "dptnet": (dict(dprnn_blocks=1), 0),
    "skim": (dict(dprnn_blocks=2), 0),
    "rnn": (dict(encoder_type="stft", rnn_layers=1), 0),
    "dan": (dict(encoder_type="stft", rnn_layers=1), 0),
    "dc_crn": (dict(encoder_type="stft"), 0),
    "dccrn": (dict(encoder_type="stft", dccrn_rnn_layer=1), 0),
    "dpcl_e2e": (dict(encoder_type="stft", rnn_layers=1), 0),
    "svoice": (dict(svoice_layers=1), 0),
    "fasnet": (dict(fasnet_layers=1), 2),
    "ineube": (dict(ineube_tcn_repeats=1, ineube_output_from="dnn2",
                    ineube_mics=2), 2),
    "beamformer": (dict(num_spk=1, use_wpe=True), 2),
}
ENH_OTHERS_SAMPLES = 16000  # B=2 x 1 s
# the CLIs and run_enh: a conformer separator of one layer at full width
ENH_CLI_ARGS = ("--model.separator_type conformer --model.trans_layers 1 "
                "--run.max_epoch 1 --run.log_interval 1000 "
                "--run.best_metric valid.loss.min --optim.schedule constant "
                "--optim.lr 0.001 --data.batch_size 4")


def enh_batch(torch, np, b, n, num_spk=2, mics=0, seed=0, device="cuda"):
    """(mixture (B, n) or (B, n, mics), lengths (B,), references
    (B, n, num_spk)): seeded tones and noise, the mixture their sum."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SAMPLE_RATE
    refs = np.stack([
        np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t
                               + rng.uniform(0, 6)) + 0.05 * rng.randn(n)
                  for _ in range(num_spk)], -1) for _ in range(b)])
    mix = refs.sum(-1)
    if mics:
        mix = np.stack([np.roll(mix, c, axis=1) for c in range(mics)], -1)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(device)  # noqa: E731
    lens = torch.full((b,), n, dtype=torch.int32, device=device)
    return as_t(mix), lens, as_t(refs)


def enh_model(torch, seed, device="cuda", **overrides):
    """The port's EnhancementModel at EnhConfig's defaults with
    `overrides`, its parameters drawn from `seed`, on `device`."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.enh import EnhancementModel, EnhConfig

    model = EnhancementModel(EnhConfig(**overrides))
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def enh_kernels(torch, np, serve_batch):
    """The kernels at this slice's shapes against their plain versions,
    float32 (the model's default) and bf16: rel-pos forward and backward
    at the training shape B=8, H=4, T'=3199, D=64 (ragged), its forward
    at the shape of `serve_batch` (`enh_serve_batch`: B, the padded T'
    and each mixture's frames); the pre-norm FFN at D=256, F=1024 on
    M=8x3199 rows (swish, 0.5: the conformer; relu, 1.0: the
    transformer); the conv head and tail at M=8x3199 and the whole-module
    kernel at B=8, T'=3199, D=256, k=15 (ragged), forward and backward;
    flash at B=8, H=4, T'=3199, D=64 with SDPA beside it. Returns the
    float32 results of the new rows."""
    import types

    import torch.nn.functional as F

    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from espnet_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                       relpos_attention_plain)

    b, t = ENH_BATCH, ENH_T
    ragged = [t, t, t - 399, t - 799, t, t // 2, t - 199, t - 1199]
    mix, lens = serve_batch
    sb, st = mix.shape[0], (mix.shape[1] - 20) // 10 + 1
    serve_frames = [(int(n) - 20) // 10 + 1 for n in lens]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args, flops, nbytes = relpos_case(torch, b, t, dtype, ragged, 71)
        label = f"enh B={b} H=4 T={t} D=64 ragged"
        with torch.no_grad():
            fwd = check_kernel(torch, "relpos_attention", relpos_attention,
                               relpos_attention_plain, args, flops, nbytes,
                               dn, label, iters=5)
        gout = torch.randn(b, 4, t, 64, generator=torch.Generator()
                           .manual_seed(72)).to("cuda", dtype)
        es = 4 if dtype == torch.float32 else 2
        bwd = check_grads(torch, "relpos_attention_bwd", dn, label,
                          relpos_attention, relpos_attention_plain, args, 6,
                          gout, 16.0 * b * 4 * t * t * 64,
                          (7 * b * 4 * t * 64 + 2 * 4 * (2 * t - 1) * 64) * es
                          + b * t * 4 + b * 4 * t * 12, iters=3)
        del args, gout
        args, flops, nbytes = relpos_case(torch, sb, st, dtype,
                                          serve_frames, 73)
        with torch.no_grad():
            serve = check_kernel(
                torch, "relpos_attention", relpos_attention,
                relpos_attention_plain, args, flops, nbytes, dn,
                f"enh serve B={sb} H=4 T={st} D=64 ragged", iters=3)
        del args
        lengths = [ragged[i % len(ragged)] for i in range(b)]
        args, flops, nbytes, valid = flash_case(torch, b, t, dtype, lengths,
                                                74)
        with torch.no_grad():
            fa = check_kernel(torch, "flash_attention", flash_attention,
                              flash_attention_plain, args, flops, nbytes,
                              dn, f"enh transformer B={b} H=4 T={t} D=64",
                              iters=5)
            fa["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *args[:3], attn_mask=valid), 5)
        log("kernels", f"flash_attention enh T={t} {dn}: library "
            f"(scaled_dot_product_attention, boolean key mask) "
            f"{fa['library_ms']:.4f} ms")
        del args, valid
        if dtype == torch.float32:
            rows.update({"relpos_attention_t3199": fwd,
                         "relpos_attention_bwd_t3199": bwd,
                         "relpos_attention_enh_serve": serve,
                         "flash_attention_t3199": fa})
        conv = check_conv_kernels(torch, dn, dtype, "enh", b * t, b, t,
                                  ragged, 0.1, True, 3, kernel_size=15)
        if dtype == torch.float32:
            rows.update({"conv_module_k15": conv["conv_module"],
                         "conv_module_bwd_k15": conv["conv_module_bwd"]})
        torch.cuda.empty_cache()
    enh = types.SimpleNamespace(d_model=256, d_ff=1024, dropout_rate=0.1)
    check_ffn_rows(torch, enh, b * t, f"enh conformer M={b}x{t}")
    check_ffn_rows(torch, enh, b * t, f"enh transformer M={b}x{t}", "relu",
                   1.0)
    return rows


def enh_grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def enh_parity(torch, np, smi):
    """A float32 train step's forward and backward of the conformer
    separator at EnhConfig's defaults on B=8 x 32000 samples, kernels
    against the plain path on the same parameters and dropout draws: the
    loss and every gradient."""
    model = enh_model(torch, 0, separator_type="conformer")
    model.train()
    batch = enh_batch(torch, np, ENH_BATCH, ENH_CHUNK, seed=1)
    out = {}
    for route in (True, False):
        model.set_use_kernels(route)
        model.zero_grad(set_to_none=True)
        wrappers = reset_counts()
        loss, _ = model(*batch, generator=torch.Generator(
            device="cuda").manual_seed(5))
        loss.backward()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        out[route] = (float(loss), enh_grads(model), counts)
    model.set_use_kernels(True)
    want = ENH_STEP["conformer"]
    if out[True][2] != want or out[False][2]:
        raise AssertionError(f"enh parity launches {out[True][2]} / "
                             f"{out[False][2]}, expected {want} / none")
    (lk, gk, _), (lp, gp, _) = out[True], out[False]
    if not np.isfinite(lk) or abs(lk - lp) > ENH_LOSS_RTOL * abs(lp):
        raise AssertionError(f"enh parity loss {lk} vs plain {lp}")
    worst, name = 0.0, ""
    top = max(float(w.abs().max()) for w in gp.values())
    for n, w in gp.items():
        g = gk[n]
        if n.endswith(ZERO_GRAD_LEAVES):
            # identically 0 (softmax is shift-invariant): rounding only
            tiny = max(float(g.abs().max()), float(w.abs().max()))
            if tiny > ENH_ZERO_GRAD_REL * top:
                raise AssertionError(f"enh parity: {n} gradient {tiny:.3e}"
                                     f" is not 0 up to rounding")
            continue
        rel = float((g - w).double().norm() / w.double().norm().clamp(
            min=TRAIN_GRAD_FLOOR))
        if rel > worst:
            worst, name = rel, n
    if worst > ENH_GRAD_REL_L2:
        raise AssertionError(f"enh parity: {name} gradient relative L2 "
                             f"{worst:.3e} > {ENH_GRAD_REL_L2}")
    log("enh", f"conformer float32 B={ENH_BATCH} x {ENH_CHUNK} (T'={ENH_T}) "
        f"kernels vs plain: loss {lk:.6f} vs {lp:.6f}, {len(gp)} gradients "
        f"worst relative L2 {worst:.3e} ({name}; limit {ENH_GRAD_REL_L2}; "
        f"the key biases' 0 up to {ENH_ZERO_GRAD_REL} of {top:.3e}) [{smi}]")
    del model, out


def enh_timed(torch, np, smi, name, dtype, separator, conv_module,
              per_step):
    """A warm-up step, then ENH_TIMED_STEPS timed train steps (FlatAdam,
    B=8 x 32000) of `separator` at EnhConfig's defaults (the conformer's
    conv sub-block on the whole-module kernel with `conv_module`): ms/step,
    peak GiB, the exact launches. Returns the launches."""
    from espnet_tpu_torch.models.conformer import ConformerBlock
    from espnet_tpu_torch.tasks.enh import ENH_BATCH_KEYS
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    model = enh_model(torch, 2, separator_type=separator, dtype=dtype)
    for block in model.modules():
        if conv_module and isinstance(block, ConformerBlock):
            block.fused_conv = True
    opt = build_optimizer("adam", 1e-3, "constant", 0, 256)
    step = make_train_step(model, opt, "cuda", batch_keys=ENH_BATCH_KEYS)
    state = TrainState.create(model, opt)
    mix, lens, refs = enh_batch(torch, np, ENH_BATCH, ENH_CHUNK, seed=3)
    batch = {"speech_mix": mix, "speech_mix_lengths": lens,
             "speech_ref": refs}
    gen = torch.Generator(device="cuda").manual_seed(6)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    losses = []
    for _ in range(ENH_TIMED_STEPS):
        state, stats = step(state, batch, gen)
        losses.append(float(stats["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / ENH_TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: w.launches for k, w in wrappers.items()}
    want = expected_counts(per_step, ENH_TIMED_STEPS)
    if counts != want:
        raise AssertionError(f"enh {name} {dtype}: launched {counts}, "
                             f"expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"enh {name} {dtype}: losses {losses}")
    log("enh", f"{name} train step {dtype} B={ENH_BATCH} x {ENH_CHUNK}: "
        f"{ms:.1f} ms/step, peak {peak:.2f} GiB, loss {losses[-1]:.4f}, "
        f"launches exact {({k: v for k, v in counts.items() if v})} [{smi}]")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


def enh_others(torch, np, smi, device="cuda", samples=ENH_OTHERS_SAMPLES):
    """Every other separator type at reduced depth on B=2 x 1 s: a float32
    forward and backward in training mode with a finite loss and
    gradients, and no kernel launched (none of them reaches one but
    DPTNet, whose attention is flash). (device="cpu" with fewer `samples`
    rehearses it without a card.)"""
    for name, (over, mics) in ENH_OTHERS.items():
        model = enh_model(torch, 4, device, separator_type=name, **over)
        model.train()
        n_spk = over.get("num_spk", 2)
        batch = enh_batch(torch, np, 2, samples, n_spk, mics, 7, device)
        wrappers = reset_counts()
        t = time.perf_counter()
        loss, _ = model(*batch, generator=torch.Generator(
            device=device).manual_seed(8))
        loss.backward()
        sync(torch, device)
        wall = time.perf_counter() - t
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        loss = loss.detach()
        if not np.isfinite(float(loss)) or not all(
                bool(torch.isfinite(g).all()) for g in grads) or not grads:
            raise AssertionError(f"enh {name}: loss {float(loss)} or a "
                                 "gradient not finite")
        want = {"flash_attention": 2} \
            if name == "dptnet" and device == "cuda" else {}
        if counts != want:
            raise AssertionError(f"enh {name}: launched {counts}, "
                                 f"expected {want}")
        log("enh", f"{name} {over} B=2 x {samples}"
            f"{f' x {mics} mics' if mics else ''}: forward+backward "
            f"{wall:.2f}s, loss {float(loss):.4f}, launches {counts} [{smi}]")
        del model


def enh_experiment(torch, ws, seed, **overrides):
    """An experiment dir (config.yaml, ep1.params.msgpack) of a randomly
    initialised model at EnhConfig's defaults with `overrides`."""
    from espnet_tpu_torch.convert import model_params
    from espnet_tpu_torch.models.enh import EnhConfig
    from espnet_tpu_torch.tasks.abs_task import OptimConfig, RunConfig
    from espnet_tpu_torch.tasks.enh import EnhDataConfig, EnhTask
    from espnet_tpu_torch.train.msgpack_io import save_tree

    exp = ws / "exp_serve"
    exp.mkdir(parents=True, exist_ok=True)
    cfg = {"run": RunConfig(output_dir=str(exp)), "optim": OptimConfig(),
           "data": EnhDataConfig(), "model": EnhConfig(**overrides)}
    EnhTask.dump_config(cfg, exp)
    model = enh_model(torch, seed, "cpu", **overrides)
    save_tree(exp / "ep1.params.msgpack", model_params(model))
    return exp


def enh_write_mixtures(np, data, seconds, seed):
    """A data dir of mixtures of the given lengths with both references."""
    from espnet_tpu_torch.data.fileio import DatadirWriter, write_wav

    rng = np.random.RandomState(seed)
    with DatadirWriter(data) as w:
        for i, s in enumerate(seconds):
            n = int(s * SAMPLE_RATE)
            t = np.arange(n) / SAMPLE_RATE
            srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
                    + 0.03 * rng.randn(n) for _ in range(2)]
            key = f"mix{i}"
            for name, wav in (("wav.scp", srcs[0] + srcs[1]),
                              ("spk1.scp", srcs[0]), ("spk2.scp", srcs[1])):
                path = data / "wav" / f"{key}_{name[:-4]}.wav"
                write_wav(path, wav / 1.5, SAMPLE_RATE)
                w[name][key] = str(path)


def enh_serve_batch(torch, np, data):
    """Writes the mixtures of ENH_SERVE_SECONDS to `data` and returns them
    as `enh_inference` batches them (the task's data section, one batch):
    (mixtures (B, n) padded, lengths (B,)), on the card."""
    from espnet_tpu_torch.data.dataset import EnhDataset, EpochIterator
    from espnet_tpu_torch.tasks.enh import EnhDataConfig, make_batches

    enh_write_mixtures(np, data, ENH_SERVE_SECONDS, 9)
    ds = EnhDataset(data, 2)
    batches = make_batches(ds, EnhDataConfig(),
                           batch_size=len(ENH_SERVE_SECONDS))
    batch = next(iter(EpochIterator(ds, batches, shuffle=False,
                                    fields=("speech_mix",)).epoch(0)))
    return (torch.as_tensor(batch["speech_mix"]).cuda(),
            torch.as_tensor(batch["speech_mix_lengths"]).cuda())


def enh_serve(torch, np, smi, ws, serve_batch):
    """`enh_inference` in process on the mixtures of `enh_serve_batch`
    under ws/serve, 4 of 4-6 s (one batch), with the conformer separator
    at EnhConfig's defaults: wall, RTF, the exact launches; the batch's
    separated waves of the kernel route against the plain route's."""
    from espnet_tpu_torch.bin import enh_inference

    data = ws / "serve"
    exp = enh_experiment(torch, ws, 10, separator_type="conformer")
    argv = ["--exp_dir", str(exp), "--data_dir", str(data), "--output_dir",
            str(ws / "sep"), "--batch_size", str(len(ENH_SERVE_SECONDS)),
            "--device", "cuda"]
    enh_inference.main(argv)  # warm-up: the first launches of each shape
    _, counts, wall = counted_call(enh_inference.main, argv)
    want = expected_counts({k: v * ENH_LAYERS for k, v in ENH_ENCODE.items()},
                           1)
    check_launches("enh_inference", counts, want)
    audio = sum(ENH_SERVE_SECONDS)
    model, _ = enh_inference.load_enh_experiment(exp, device="cuda")
    mix, lens = serve_batch
    t_frames = (mix.shape[1] - 20) // 10 + 1
    with torch.no_grad():
        waves = {}
        for route in (True, False):
            model.set_use_kernels(route)
            waves[route] = model.forward_enhance(mix, lens)[0]
        torch.cuda.synchronize()
    err = float((waves[True] - waves[False]).abs().max())
    if not torch.isfinite(waves[True]).all() or err > ENH_WAVE_TOL:
        raise AssertionError(f"enh serve: kernel vs plain waves {err:.3e}")
    log("enh", f"serve enh_inference conformer 4 mixtures "
        f"{'/'.join(str(s) for s in ENH_SERVE_SECONDS)} s (one batch, "
        f"T'={t_frames}): wall {wall:.2f}s, RTF {wall / audio:.4f}; "
        f"float32 waves kernels vs plain max |err| {err:.3e} (limit "
        f"{ENH_WAVE_TOL}); launches exact [{smi}]")
    del model, waves
    torch.cuda.empty_cache()
    return counts


def enh_clis(torch, np, smi, ws, device="cuda", model_args=""):
    """On a synthetic corpus (`generate_mixture_corpus`), a one-layer
    conformer separator at full width: in process `enh_train` (exact
    launches) -> `enh_inference` -> `enh_scoring`; then `run_enh` stages
    1-7, which runs those CLIs as subprocesses, and its RESULTS.md.
    (device="cpu" with `model_args`, flags that shrink the model,
    rehearses it without a card.)"""
    import shlex

    from espnet_tpu_torch.bin import enh_inference, enh_scoring, enh_train
    from espnet_tpu_torch.data.dataset import EnhDataset
    from espnet_tpu_torch.data.synth import generate_mixture_corpus
    from espnet_tpu_torch.recipe_enh import RecipeEnh, RecipeEnhConfig
    from espnet_tpu_torch.tasks.enh import EnhDataConfig, make_batches

    t0 = time.perf_counter()
    train, test = ws / "cli" / "train", ws / "cli" / "test"
    generate_mixture_corpus(train, n_utts=8, seed=0)
    generate_mixture_corpus(test, n_utts=3, seed=5)
    exp = ws / "cli" / "exp"
    args = f"{ENH_CLI_ARGS} {model_args}"
    _, counts, wall = counted_call(enh_train.main, shlex.split(args) + [
        "--run.output_dir", str(exp), "--data.train_dir", str(train),
        "--data.valid_dir", str(train), "--device", device])
    n = len(make_batches(EnhDataset(train), EnhDataConfig(batch_size=4)))
    per = 1 if device == "cuda" else 0
    step = {k: per * v // ENH_LAYERS
            for k, v in ENH_STEP["conformer"].items()}
    want = expected_counts(step, n)
    for k, v in ENH_ENCODE.items():
        want[k] += per * v * n  # the valid pass
    check_launches("enh_train", counts, want)
    sep = ws / "cli" / "sep"
    enh_inference.main(["--exp_dir", str(exp), "--data_dir", str(test),
                        "--output_dir", str(sep), "--device", device])
    enh_scoring.main(sum((["--ref_scp", str(test / f"spk{i}.scp")]
                          for i in (1, 2)), []) + sum(
        (["--inf_scp", str(sep / f"spk{i}.scp")] for i in (1, 2)), [])
        + ["--output_dir", str(ws / "cli" / "score")])
    results = (ws / "cli" / "score" / "RESULTS").read_text().split("\n")
    log("enh", f"cli enh_train ({n} batches, {wall:.1f}s, launches exact) "
        f"-> enh_inference -> enh_scoring: {'; '.join(r for r in results if r)}"
        f" [{smi}]")
    cfg = RecipeEnhConfig(expdir=str(ws / "recipe" / "exp"),
                          datadir=str(ws / "recipe" / "data"), synth_utts=8,
                          enh_args=args)
    t = time.perf_counter()
    RecipeEnh(cfg, device=device).run()
    rexp = ws / "recipe" / "exp"
    missing = [s for s in range(1, 8) if not (rexp / f".stage{s}.done")
               .exists()]
    if missing or not (rexp / "RESULTS.md").exists():
        raise AssertionError(f"run_enh: stages {missing} not done")
    log("enh", f"run_enh stages 1-7 {time.perf_counter() - t:.1f}s"
        f": {(rexp / 'results.json').read_text().split()[:8]}; clis "
        f"{time.perf_counter() - t0:.1f}s")


def phase_enh(torch, np, smi):
    """The enhancement slice: the kernels at its shapes; the conformer
    separator's float32 train step with kernels against plain; timed train
    steps of the conformer (plain and whole-module conv routes), the
    transformer and the TCN separators in float32 and bf16; every other
    separator type at reduced depth; `enh_inference` serving; the CLIs and
    `run_enh`. Returns (the new kernel rows' results, the launches by
    path)."""
    import shutil
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    ws = Path(tempfile.mkdtemp(prefix="chip_smoke_enh_"))
    try:
        serve_batch = enh_serve_batch(torch, np, ws / "serve")
        rows = enh_kernels(torch, np, serve_batch)
        enh_parity(torch, np, smi)
        launches = {}
        for name, sep, module in (("conformer", "conformer", False),
                                  ("conformer_conv_module", "conformer",
                                   True),
                                  ("transformer", "transformer", False),
                                  ("tcn", "tcn", False)):
            for dtype in ("float32",) if module else ("float32",
                                                      "bfloat16"):
                got = enh_timed(torch, np, smi, name, dtype, sep, module,
                                ENH_STEP[name])
                if dtype == "float32":
                    launches[f"enh_{name}"] = got
        enh_others(torch, np, smi)
        launches["enh_serve"] = enh_serve(torch, np, smi, ws, serve_batch)
        enh_clis(torch, np, smi, ws)
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    log("enh", f"phase {time.perf_counter() - t0:.1f}s")
    return rows, launches


def main() -> int:
    import numpy as np
    import torch

    from espnet_tpu_torch.configs import bench_config, encoder_options

    name, smi = phase_device(torch)
    phase_build()
    cfg = bench_config(torch.bfloat16)
    serve_b, serve_t = serve_shapes(cfg, requests(np)[1])
    phase_kernels(torch, serve_b, serve_t)
    results = phase_train_kernels(torch, np)
    launches = {c: run_config(torch, np, c, bench_config(torch.bfloat16, c),
                              *counts, options=encoder_options(c))
                for c, counts in CONFIGS.items()}
    for c, (overrides, *counts) in GATE_CONFIGS.items():
        run_config(torch, np, c, bench_config(torch.bfloat16, **overrides),
                   *counts, parity=False, train_batch_size=16, train_steps=1)
    phase_cli(torch, np, smi)
    phase_asr_variants(torch, np, smi)
    phase_recipe(torch, np, smi)
    phase_trained_exp(torch, np, smi)
    phase_streaming(torch, np, smi)
    rnnt_results, launches["transducer"] = phase_transducer(torch, np, smi)
    phase_asr_families(torch, np, smi)
    phase_asr_multi(torch, np, smi)
    phase_lm_fusion(torch, np, smi)
    phase_translation(torch, np, smi)
    phase_ssl(torch, np, smi)
    results["flash_attention_d192"], launches["fastspeech2"] = phase_tts(
        torch, np, smi)
    results["flash_attention_d96"], launches["vits"] = phase_gan(
        torch, np, smi)
    enh_rows, enh_launches = phase_enh(torch, np, smi)
    results.update(enh_rows)
    launches.update(enh_launches)
    results.update(rnnt_results)
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[MAIN_PATH.get(kname, "conformer")][
                ROW_OF.get(kname, kname)],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ok": True, "max_err": r["max_abs_err"], "kernel_ms": r["ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done", f"total {time.perf_counter() - _T0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
