#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mvp_pytorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep float32   # phase 3 alone, in one dtype
    python3 chip_smoke.py --cli             # phase 7 alone
    python3 chip_smoke.py --pretrain_cli    # phase 8 alone
    python3 chip_smoke.py --finetune_cli    # phase 9 alone
    python3 chip_smoke.py --nlvr_cli        # phase 10 A alone
    python3 chip_smoke.py --serve           # phase 10 B alone
    python3 chip_smoke.py --single_stream   # phase 11 alone
    python3 chip_smoke.py --captioning      # phase 12 alone
    python3 chip_smoke.py --detection       # phase 13 A and B alone
    python3 chip_smoke.py --scst_cbs        # phase 13 C-E alone
    python3 chip_smoke.py --parallel        # phase 14 alone
    python3 chip_smoke.py --tooling         # phase 15 alone
    python3 chip_smoke.py --runbook_ingest  # phase 16 alone
        [--device_demand_ex_s N]            # its demand without phase 8
    (`--serve_clients URL JOBS OUT` is phase 10 B's client process, which
    the script starts itself)

Phases, each ended by torch.cuda.synchronize(); any failure raises and the
script exits non-zero:
1. print the card (name, power limit) and build the kernels from csrc/
   (four translation units, one nvcc each, started together); print each
   kernel's registers and spills (ptxas), its tensor-core
   instructions (HMMA/HGMMA in the SASS, from cuobjdump) and its resident
   blocks per SM; fail if a bf16 or an fp32 (3xTF32) kernel has no
   tensor-core instruction, or a dropout instantiation another count than
   its p = 0 twin;
2. hold the masked-attention kernel against its plain PyTorch version at the
   main path's shapes (fused L 125, text 75, vision 70; H 12, D 64; B 1,000
   and 8), both dtypes, both layouts, with padded 2-D key masks, 3-D masks,
   Lk > Lq, fully-masked rows, a bf16 bias and D 32 / 128, and across the
   bf16 kernel's 128-row tiles (Lk 200, L 160, B 1, odd lengths 17 / 129 and
   1 / 1); tolerances fp32 2e-5, bf16 0.05. Time the kernel, the plain
   version and, as a yardstick the port never calls,
   F.scaled_dot_product_attention with the same mask, at the main path's
   batches (1,000 pairs fused; 500 text or images). Then the attention
   backward (`MaskedAttentionFn`: the kernel forward, the recompute backward)
   at the training shapes (B 96; L 125, 75, 70), both dtypes and layouts,
   padded key masks with a fully-masked row and a 3-D mask: q, k, v and bias
   grads against torch autograd through the plain version in fp32 on the
   same values (fp32 1e-4, bf16 0.05); the forward and the backward timed
   beside the plain version's and, as a yardstick the port never calls,
   F.scaled_dot_product_attention forward and forward+backward. Then the
   attention-prob dropout (p 0.1) inside the kernel, both dtypes and
   layouts: the kernel's mask read back (q = k = 0, v = I at Lk = D = 64, so
   each output row is keep / (64 (1 - p))) equal bit for bit to the plain
   hash's at B 96, L 125, with a keep share within 0.002 of 0.9; the dropout
   kernel against the plain dropout version at the training shapes
   (fp32 2e-5, bf16 0.05) and its backward against fp32 autograd of the
   plain dropout version (fp32 1e-4, bf16 0.05); the dropout kernel timed
   beside the p = 0 kernel and F.scaled_dot_product_attention(dropout_p=0.1).
   At NLVR2's fusion input (fused L 140, past the 128-key tile: the
   online-softmax kernels; B 64 and 32, the text and both images' regions
   padded, so that masked keys fill most rows' second key tile): the kernel
   against the plain version in both dtypes and layouts, at p 0 and, with
   the backward, at p 0.1; the dropout mask read back bit for bit at Lq =
   Lk = 140 (v one-hot over three windows of D keys, one launch each) with
   its keep share; and the kernel timed beside the plain version, SDPA and
   its bound at fused L 140 (B 64 / 32, bf16 p 0.1 and 0, fp32 p 0) and at
   the fine-tuning vision stream (L 70, B 64 / 32, bf16 p 0.1 and 0);
3. two-stage retrieval scoring at MVPTR-base width and depth (hidden 768,
   6+6+6 layers, vocab 86,051, seeded random weights) at the bench
   geometry: 1,000 images x 5 captions, LA 75, T 20, R 50, K 20/10, encoder
   batch 500, pair batch 1,000: two sweeps in bf16, then one in fp32 (the
   default `ModelConfig.dtype`; matmuls in full fp32, TF32 off), each after
   a warm-up on a subset; every sweep must launch the kernel exactly
   6 x (10 + 2 + 70) = 492 times; pairs/s and peak memory;
4. the kernel path against the plain path end to end at full width on a few
   padded captions and images: ITM probabilities and global embeddings;
5. the retrieval training step at MVPTR-base (bf16 over fp32 weights, the
   config's dropouts 0.1 / 0.1) on one fixed batch of 96 (LA 75, T 20, R 50,
   hard negatives), AdamW lr 4e-5 with clip 1.0: 3 warm-up steps through
   `train_retrieval`, then 10 timed `Trainer` steps; exactly 24 kernel
   launches per step, all of them the dropout instantiation, finite losses
   and a last loss below the first; step ms, samples/s and peak memory.
   Then one step's kernel path against its plain path (the same dropout
   masks, drawn from the same generator), in fp32 and bf16, with the hard
   pairs pinned to the kernel run's: the losses and the relative error of
   the gradients of a query weight of each encoder, the classifier and
   logit_scale;
6. the pretraining step (`BiPretrainModel`, the five losses) at MVPTR-base
   in bf16 at the config's dropouts 0.1 / 0.1, on bench.py's pretraining
   geometry (bench.py:416-440: B 96, LA 75 = 70 text + 5 phrase slots, T 20,
   R 50, 8 masked text and 3 masked tag positions, max_pred 20 / 10, phrase
   span [9, 14], image span [75, 125], WRA 'sample', hard negatives), half
   the captions and images padded, AdamW lr 1e-4: 3 warm-up steps through
   `train_pretrain`, then 10 timed `Trainer` steps; exactly 24 kernel
   launches per step, all of them the dropout instantiation, no call of the
   plain attention, finite losses and a last loss below the first; step ms,
   samples/s and peak memory. Then one step at dropouts 0 with the QA heads
   (3,129 answers, QA-pair relation), the slot permutation, the WRA pick and
   negative and the hard pairs pinned: kernel path against plain path, in
   fp32 and bf16, on the seven losses and five named gradients (phase 5's
   tolerances);
7. the retrieval command line (`tasks.retrieval.main`) at MVPTR-base on a
   root it writes under `_smoke/` with the port's `tsv_writer` at
   bench.py:99-105's Flickr30k test geometry (1,000 images x 5 captions,
   50 regions x 2,054 fp32 and 50 tags an image, captions past LA 75 =
   70 text + 5 phrase slots): 13 batches of 96 fetched into memory and
   trained with `train_retrieval` (bf16, the config's dropouts 0.1 / 0.1,
   the CLI's default lr 4e-5, linear decay); then 26 steps through the CLI
   and its process loader (4 forked workers),
   each step launching the dropout kernel exactly 24 times and the plain
   attention never, the losses finite and the last five below the first
   (from seeded weights they fall to chance and stay there), step 1's loss
   equal to the in-memory run's (the loader delivered the sampler's batch); samples/s over steps
   6-26 beside the in-memory steps 4-13 (target ratio 0.90, not a failure),
   the main thread's data ms a step, the workers' ms a batch, the H2D copy's
   device ms and whether the native decode is on; then the CLI's eval of
   the trained checkpoint (K 20 / 10, encoder batch 500, rerank batch
   1,000): exactly 492 launches, and ranks, candidates and fine scores
   (within 1e-6) equal to `two_stage_scoring` on the dataset's arrays in
   memory. The root is deleted at the end;
8. the pretraining command line (`tasks.pretrain.main`) at MVPTR-base on
   phase 7's root plus a corpus of 5 rows an image (5,000 rows of 90-word
   captions with 8 phrases; every other row a QA pair whose answer is one
   of the image's tags) and a tag2id.json: LA 75, T 20, R 50, bf16, the
   config's dropouts 0.1 / 0.1, lr 1e-4, hard negatives, WRA 'sample',
   mask_prob 0.15. The first batch's masked shares of text tokens and of
   regions within 0.15 +- 0.02, the region labels on exactly the zeroed
   regions; the process loader's batch at the first step of epoch 1 equal
   to the fetch with epoch 1 and unlike epoch 0's masks of the same rows.
   13 masked batches fetched into memory and trained with `train_pretrain`;
   one dropout-0 step on the first of them, kernel path against plain path:
   in fp32 the six losses and five named gradients (phase 5's fp32
   tolerances), in bf16 the losses (0.02) with the gradients printed beside
   each path's distance from the fp32 gradient; 26 steps through
   the CLI and its process loader (4 forked workers), each launching the
   dropout kernel exactly 24 times and the plain attention never, finite
   losses, the last five below the first, step 1's loss equal to the
   in-memory run's; samples/s over steps 6-26 beside the in-memory steps
   4-13 (target ratio 0.90, not a failure), main-thread data ms, worker ms
   and H2D ms; then 3 CLI steps with `--use_qa --qa_answer_size 3129
   --use_qa_pairs`, finite QA losses. The root is deleted at the end;
9. VQA, SNLI-VE and referring-expression fine-tuning through their command
   lines (`tasks.vqa`, `tasks.ve`, `tasks.re_task`) at MVPTR-base, bf16 over
   fp32 weights, the config's dropouts 0.1 / 0.1, LA 40 (35 + 5 phrase
   slots), T 20, R 50, on a root written under `_smoke/` like phase 7's
   (1,000 images, region boxes in the last 6 feature dims) with 2,000 VQA
   questions over 3,129 answers (up to 10 soft scores each), 3,000 SNLI-VE
   hypotheses, 1,000 expressions whose gt box is a region's and up to 20
   detections an image, each following `data/synthetic.py`'s learnable rule.
   First the kernel at the fine-tuning shapes (fused L 90 and text L 40 at
   B 64 and 32, bf16, p 0.1 and 0): against the plain version (0.05) and
   timed beside the plain version and SDPA. (a) VQA (QA head, bce, B 32, lr
   5e-5): on the first real batch at dropout 0, kernel path against plain
   path (logits and loss fp32 1e-4; bf16 logits 4 bf16 ulps at the largest
   |logit|, bf16 loss 1e-4 of the loss, each path's distance from fp32
   printed; the relative error of five named gradients fp32 1e-3, bf16
   printed beside each path's distance from fp32); 13 steps in memory, then 26 through the CLI and its process loader
   (4 forked workers), each launching the dropout kernel exactly 18 times (6
   layers x text, vision, one fusion pass) and the plain attention never,
   finite losses, step 1's loss equal to the in-memory run's; the CLI's
   eval and `--test_jsonl` of the checkpoint over 1,000 questions: 18 p = 0
   launches a batch, logits within 1e-6 of the model's forward on the
   dataset's arrays in memory, the same VQA accuracy, one answer a question
   from label2ans; 3 CLI steps with `--loss_type kl --adjust_loss_step 2
   --adjust_dp_step 2`: kl before step 2 and bce from it, the hidden
   dropouts 0.1 then 0.3 while the kernel's p stays 0.1. (b) SNLI-VE
   (B 64, lr 4e-5, `--mask_training --freeze_steps 5`): 13 CLI steps of 18
   launches, every `bert.*` parameter bitwise unchanged through step 5 and
   changed after it, the classifier moving from step 1, the CLI's eval
   accuracy over 1,000 pairs equal to the forward in memory; 3 steps with
   `--use_single`. (c) RE (`REModel` mod 1, `--phrase_layer 2`, B 32,
   `--det_json`): 13 CLI steps of 18 launches, `re_accuracy` and the two
   detection-grounded accuracies equal to those of the forward in memory; 3
   steps at `--loss_mod 3`. Step ms, samples/s, peak memory, main-thread
   data ms, worker ms and the VQA feed ratio (target 0.90, not a failure)
   are reported. The root is deleted at the end;
10. (A) NLVR2 through its command line (`tasks.nlvr`) at MVPTR-base, bf16,
   the config's dropouts 0.1 / 0.1, B 32, LA 40 (35 + 5 phrase slots), T 20,
   R 50 (fused L 140), lr 4e-5, on phase 7's generated images with 2,000
   training and 1,000 eval statements over pairs of distinct images, each
   naming a tag of exactly one of its images (true iff img0's: the port's
   `data/synthetic.py` rule). The first 3 real batches at dropout 0, kernel
   path against plain path: fp32 logits and loss within 1e-5 and five named
   gradients within 1e-3 relative; in bf16, over the 3 batches together,
   the kernel path's largest distance from the fp32 plain path at most 1.25
   times the bf16 plain path's, plus 1 bf16 ulp at the largest |logit|; the
   examples' cross entropies (the loss is their mean, whose errors cancel
   by chance) likewise, plus 1e-4 of the largest, and the loss their mean.
   The first batch 13 times in memory (its loss must fall),
   then 26 steps through the CLI and its process loader (4 forked workers),
   each launching the dropout kernel exactly 24 times (6 layers x text, two
   images, one fusion pass), 6 of them at Lk 140, and the plain attention
   never, finite losses, step 1's loss equal to the in-memory run's; the
   CLI's eval of the checkpoint over the 1,000 eval statements (batches of
   64, the last padded): 24 p = 0 launches a batch, logits within 1e-6 of
   the model's forward on the dataset's arrays in memory and the same
   accuracy. Step ms, samples/s, peak memory, the feed ratio (target 0.90,
   not a failure) and the workers' ms a batch are reported.
   (B) Serving: a seeded MVPTR-base `BiPretrainModel` checkpoint (bf16
   config) written by the port's `CheckpointManager`, phase 7's feature TSV
   as the `FeatureStore` backend; `tasks.serve.main` in-process on a thread
   with both modes, `--max_batch 16 --batch_wait_ms 5` (LA 35, T 20, R 50:
   fused L 85); 256 single requests (128 `/v1/mlm` with one or two
   [MASK]s, 128 `/v1/embedding`) and 4 `/v1/batch` requests of 16 pairs
   from 32 client threads of a client process: exactly 18 p = 0 launches
   per batched forward and no plain attention; `/healthz` with fewer batches
   than requests and a largest batch above 1; every answer against direct
   forwards of the same padded batches of 16: the kernel path (mlm tokens
   equal wherever the top-2 gap exceeds a bf16 ulp, the others counted;
   embeddings within 1e-6), the bf16 plain path (mlm tokens equal wherever
   its top-2 gap exceeds twice the position's largest |kernel - plain|) and
   the fp32 plain path (the mlm logits and each of the four embedding
   outputs by the 1.25 rule of (A), one bf16 ulp at the largest |value|).
   Requests/s, p50 and p99 ms per mode, the device ms of a batched forward,
   load and warm-up seconds, and the host ms of a request's preparation, of
   an embedding answer's JSON, of a batch's H2D copy and of a forward are
   reported. Then `python -m
   mvp_pytorch_tpu_torch.tasks.serve` as a subprocess: one request, then
   SIGTERM, which must drain and exit 0. The root is deleted at the end;
11. the single-stream model (`ImgBertModel`, 12 layers over [text ; tags ;
   regions]) at MVPTR-base on phase 8's root: LA 75, T 20, R 50, one
   sequence of 145 keys (every layer on the online kernels), bf16 over fp32
   weights, dropouts 0.1 / 0.1, B 96, lr 1e-4. (a) The kernel at Lq = Lk =
   145, B 96, both dtypes and layouts, p 0 and 0.1, padded key masks and a
   [B, 1, L, L] seq2seq mask: against the plain version (fp32 2e-5, bf16
   0.05) with its grads against fp32 autograd of the plain version (1e-4 /
   0.05); the dropout mask read back bit for bit with its keep share; the
   kernel timed beside the plain version, SDPA and its bound (bf16 p 0.1
   and 0, fp32 p 0), and at the serving forward's shapes (B 16: fused L 85,
   text L 35, vision L 70). (b) `--visual_learning` (`ImgBertForPreTraining`,
   MLM + ITM + MRC over 2,000 tags + MRF): the first batch's masked shares
   within 0.15 +- 0.02, region labels only on the zeroed regions, the MRF
   targets equal to the stored features; one dropout-0 step on it, kernel
   path against plain path (fp32: the five losses 1e-4 and five gradients
   1e-3 relative; bf16: the losses 0.02 and each gradient's relative
   distance from the fp32 plain path's at most 1.25 times the plain bf16
   path's plus 2^-8); 13 batches in memory, then 26 CLI steps through the
   process loader (4 forked workers), each launching the dropout kernel
   exactly 12 times, all at Lk 145, and the plain attention never, finite
   losses, the last five below the first, step 1's loss equal to the
   in-memory run's; step ms, samples/s, peak memory, the feed ratio (target
   0.90, not a failure), worker ms and H2D ms. (c) `--extra_mode img_only`,
   then `text_only`: 3 CLI steps each, 48 dropout launches a step (24 main
   + 24 extra), finite extra losses, step 1's total equal to the same
   batch's in memory. (d) `ImgBertForSequenceClassification` (3,129
   labels) at B 64 with a [B, L, L] seq2seq mask and with a per-layer list:
   12 p = 0 launches at Lk 145 each, kernel path against plain path (fp32
   logits 1e-5, bf16 by the 1.25 rule of 10 (A)). The root is deleted at the
   end;
12. captioning (`CaptioningModel` over `ImgBertModel`) at MVPTR-base on
   phase 7's root: caption 35, T 20, R 50 (L 105), the LM head over all
   86,051 rows, bf16 over fp32 weights, dropouts 0.1, B 64, lr 3e-5, label
   smoothing 0.1, drop-worst 0.2 from step 14; decoding with
   `--max_gen_length` 20. (a) The kernel at the captioning shapes, both
   dtypes: L 105 at B 64 under the seq2seq bias at p 0 and 0.1 (grads
   against fp32 autograd of the plain version), the cached decode step
   (Lq 2 / Lk 92 with its per-query bias at N 250 and 1,250; Lq 1 / Lk 91)
   and the recompute forward (L 90, N 250), against the plain version
   (fp32 2e-5, bf16 0.05), timed beside the plain version, SDPA and the
   bound. (b) One dropout-0 step on the first real batch, kernel path
   against plain path (fp32: the loss 1e-4, five gradients 1e-3 relative;
   bf16 by the 1.25 rule). (c) 13 batches in memory, then 26 CLI steps
   through the process loader (4 forked workers), each launching the
   dropout kernel 12 times, all at Lk 105, and the plain attention never;
   finite losses, the last five below the first, step 1 equal to memory's;
   step ms, samples/s, peak memory, the feed ratio, worker and H2D ms. (d)
   With the CLI's checkpoint, 250 images decoded greedy and beam-5, each
   history-cached (240 launches: 12 at L 70, then 19 steps of 12 at Lk 92)
   and recomputed (228 at L 90), p 0, plain 0; captions/s, ms per step,
   the speed-up, the bf16 rows that differ and, from one profiled run
   each, the card's busy share and device ms by kernel class; in fp32 the
   cached greedy
   sequence teacher-forced through both paths (logits within 1e-4) and the
   greedy sequences equal but at near ties. (e) `--do_eval` alone on the
   checkpoint over those images, beam 5, cached, one batch of 250: 240
   launches, finite BLEU-4, METEOR, ROUGE_L and CIDEr-D in test_eval.json,
   SPICE absent without its jar, the captions equal (d)'s. The root is
   deleted at the end;
13. from image to constrained caption on a root under `_smoke/`: (A) the
   detector at `DetectorConfig()`'s defaults (canvas 640, trunk (64, 128,
   256) x (2, 2, 2), 1,601 classes, 2,048-d features, pre-NMS 256, 50
   regions) with seeded weights: fp32 (cuDNN TF32 off) held against the CPU
   run of the same weights on 2 images (the proposal field within 1e-4 of
   its largest, NMS over the CPU's field the same indices, the RoI head
   within 1e-4 relative, class ids equal but at near ties), bf16 by the
   1.25 rule; fp32 and bf16 at B 8 and 32: ms a batch, images/s, the ms of
   the trunk, proposal heads, top-k, NMS, RoI-align and RoI head, the NMS
   call's device kernels, `_postprocess`'s host ms an image, peak memory.
   (B) `train_detector` 200 steps, held-out mAP@0.5 above 0.4; `train_cli`
   at its defaults 200 steps, the last 10 losses below 0.7 of the first.
   (C) 64 synthetic images through `tools.img_feat_extract` with (B)'s
   weights (the tool's row writer on numpy canvases where PIL is missing)
   and a label map of vocabulary words, then the captioning CLI at
   MVPTR-base, bf16: 13 steps, `--scst --scst_steps 4 --scst_batch 8
   --use_cbs --do_eval`; finite SCST losses, every CBS caption from a
   satisfying state holding its tag, the regions 2,054 wide and at most 50.
   (D) CBS on the checkpoint: 16 images, 2 two-token constraints (S 8), K
   3, 384 rows a step at L 90, 228 launches a search; ms a step,
   captions/s, the top-k's device ms, peak memory; fp32 against the plain
   path (live-slot log-probs 1e-4, best sequences equal but at near ties).
   (E) SCST, B 8 at 20 positions: the ms of each part of a step, 492
   launches a step, peak memory; one fp32 step on fixed samples, kernel
   path against plain path (loss 1e-4, five gradients 1e-3 relative). The
   kernel at the CBS step (L 90, N 384) and the SCST copy (L 90, N 160,
   with the backward) shapes against the plain version, timed beside it,
   SDPA and the bound. The root is deleted at the end;
14. parallelism on torch.distributed (the script runs on one card, and
   NCCL refuses two ranks on one device, so the multi-rank equalities are
   the CPU tests'): (A) MVPTR-base with 8 experts top-2 in every second
   layer of each encoder (9 MoE layers) through the pretraining CLI
   (`--synthetic`, B 96, dropouts 0.1, 10 steps, 24 launches a step, plain
   0): finite, falling losses and aux; dense and MoE steps on one batch in
   memory (ms, samples/s, peak memory, aux, the share of assignments over
   capacity); one fp32 MoE step at p 0, kernel path against plain path
   (the losses and the aux 1e-4, five gradients 1e-3 relative). (D) The
   MoE state (model and AdamW) through `save_sharded` and `consolidate`
   into a fresh model, bit for bit. (B) A one-rank NCCL process group: one
   fp32 retrieval step at B 96, p 0 under plain DDP, ZeRO-2, FSDP, TP (model
   1) and GPipe (one stage, 4 microbatches: 96 launches a step), each
   against the plain Trainer's (loss 1e-4, the five updates 1e-3
   relative), then timed. (C) `--coarse_block`'s streaming coarse stage at
   1,000 x 5,000 on exact, tie-free scores equal to the dense stage (the
   shortlists and the ranks), then 100,000 x 500,000 (a 200 GB dense
   matrix) timed with its peak memory. The kernel at GPipe's B 24 shapes
   (fp32, p 0) against the plain version, timed beside SDPA and the bound;
15. the tooling around the training loop, at MVPTR-base on a root like
   phase 7's: (A) the retrieval CLI (bf16, B 96, dropouts 0.1, 8 steps)
   with `--profile_dir` over steps 4-5: exactly one trace file whose device
   events of the hand-written kernel (by `kernel_key`) number the launch
   counter's count for those steps (24 a step), with no library attention
   kernel (SDPA, flash, fmha) in it; `hbm_peak_gb` and `step_peak_gb` of
   metrics.jsonl within 1 % of `torch.cuda.max_memory_allocated`; the median
   step ms inside and outside the window. (B) The trained state saved by
   `CheckpointManager.save` and through `AsyncSaver` (the snapshot, then the
   write on the writer thread while steps run): the two checkpoints equal
   bit for bit; the sync save's seconds, the async submit's blocking
   seconds, and the median step ms during the write against steps with no
   write. (C) The CLI as a subprocess in its own session (fp32, constant
   learning rate, `--async_ckpt`, --max_steps 500), SIGTERM to its process
   group after its first metrics line: rc 0 within a deadline, exactly one
   checkpoint at a step s < 500; a resume to s + 3 on the same root equal,
   within 1e-6, to an uninterrupted run to s + 3; the seconds from SIGTERM
   to exit; `inspect_ckpt`'s `n_params` of the checkpoint equal to the
   model's. (D) `tools.load_test_serve` on `build_assets` at the JAX bench's
   serving config (hidden 768, 12 layers, bf16 stored bf16, 30,522 vocab
   rows, 86,051 model rows, 512 positions): 200 requests from 16 threads,
   batched (16, 5 ms) then unbatched: 0 errors, batching seen; the first 16
   requests' answers held against direct forwards at B 16 and B 1 (each its
   own batch size's argmax where decided there; the two modes equal where
   both top-2 gaps exceed twice the logits' difference between the batch
   sizes); requests/s and p50 / p99 of each mode;
16. the release tools, at MVPTR-base: (A) `tools.parity_runbook` over a
   seeded `RetrievalModel` checkpoint in the reference's layout
   (pytorch_model.bin, config.json, vocab.txt) on a generated 100-image eval
   root at the bench geometry (LA 75, T 20, R 50, K 20 / 10), three times:
   without --expected (exit 0), with its own metrics (exit 0), with one
   metric 30 points off (exit 1); each eval subprocess launches the kernel
   as phase 7's formula says (54) and the plain version never, the three
   give the same R@K, equal to the retrieval driver's eval-only run in this
   process on the same flags; the eval wall times; the kernel at the eval's
   image batch (vision L 70, B 100, bf16) against the plain version, timed
   beside SDPA and its bound. (B)
   `tools.scale_ingest` as a subprocess onto the card: 2 GB of ~0.5 MB
   rows in 4 chunks, B 96, 4 workers, 40 steps, resumed at step 20: its
   four checks (partition, chunk fingerprints, RSS growth under its slots
   plus 400 MB, 4 resumed batches bit for bit), more bytes streamed than
   that bound; ingest_ex_s and feed_ratio against phase 8's CLI samples/s
   (or --device_demand_ex_s when phase 8 does not run);
17. one JSON line of the detector's numbers, one of phase 15's, one of
   phase 16's, then one of kernel numbers
   (the bf16 kernel, then the fp32 one; phase 11's under `single_stream`,
   phase 12's under `captioning`, phase 13's under `cbs_scst`, phase 14's
   under `parallel` and its GPipe rows under the fp32 kernel's
   `gpipe_attention`), then the result line.

With `--sweep DTYPE` only phase 3 runs, in that dtype (bf16: two sweeps,
fp32: one), and the last line is a JSON object of its numbers; run from a
copy of another tree, the script drives that tree's package. With `--cli`
only phases 1 (the build) and 7 run, the last line a JSON object of phase
7's numbers; with `--pretrain_cli`, phases 1 and 8; with `--finetune_cli`,
phases 1 and 9; with `--nlvr_cli`, phases 1 and 10 A; with `--serve`, phases
1 and 10 B; with `--single_stream`, phases 1 and 11; with `--captioning`,
phases 1 and 12; with `--detection`, phases 1 and 13 A-B; with
`--scst_cbs`, phases 1, 13 B's `train_cli` and 13 C-E; with `--parallel`,
phases 1 and 14; with `--tooling`, phases 1 and 15; with `--runbook_ingest`,
phases 1 and 16.

Exits 2 without a result when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor cores
              "float32": 495e12}     # dense TF32 tensor cores
# tensor-core passes per product: fp32 at fp32 accuracy takes three TF32
# passes (3xTF32: lo.hi + hi.lo + hi.hi)
PASSES = {"bfloat16": 1, "float32": 3}
TOL = {"float32": 2e-5, "bfloat16": 0.05}
E2E_TOL = {"float32": 1e-4, "bfloat16": 0.02}
# attention grads against fp32 autograd of the plain version: fp32, the same
# math summed in another order; bf16, the grads rounded to bf16 at |g| ~ 4
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.05}
# one training step, kernel path against plain path (hard pairs pinned):
# loss abs error, and ||g_kernel - g_plain|| / ||g_plain|| of each named
# parameter. bf16: the plain path's backward runs through bf16 scores and
# probabilities, the kernel path's recomputes them in fp32, so a few bf16
# ulps (2^-8) per element, over 18 layers
STEP_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (0.02, 0.05)}
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 96, 3, 10
GRAD_PARAMS = ("bert.txt_encoder.layer.0.attention.self.query.weight",
               "bert.vis_encoder.layer.0.attention.self.query.weight",
               "bert.mul_encoder.layer.0.attention.self.query.weight",
               "classifier.weight", "logit_scale")
PRETRAIN_GRAD_PARAMS = ("bert.embeddings.word_embeddings.weight",
                        "cls.predictions.transform.dense.weight",
                        "half_mlm.transform.dense.weight",
                        "bert.vis_encoder.layer.0.attention.self.query.weight",
                        "bert.mul_encoder.layer.0.attention.self.query.weight")
PRETRAIN_LOSSES = ("total_loss", "vis_mlm_loss", "retrieval_loss",
                   "masked_lm_loss", "itm_loss", "qa_loss", "wra_loss")
DROP_P = 0.1                         # ModelConfig's default dropouts
KEEP_SHARE_TOL = 0.002
DEVICE = "cuda"
H, D = 12, 64
LENGTHS = {"fused": 125, "text": 75, "vis": 70}
MAIN_BATCH = {"fused": 1000, "text": 500, "vis": 500}   # pair / encoder batch
KERNEL_SOURCE = "mvp_pytorch_tpu_torch/csrc/masked_attention.cuh"
REPLACES = "mvp_pytorch_tpu/ops/attention.py:114 (git 8625894^; also :169)"
# NLVR2's fusion input: the text (LA 40 = 35 + 5 phrase slots) and both
# images' tag-stripped regions (R 50 each), 140 keys: past the 128-key tile,
# so its attention runs on the online-softmax kernels
NLVR_LA, NLVR_R = 40, 50
NLVR_L = NLVR_LA + 2 * NLVR_R
NLVR_BATCHES = (64, 32)              # the eval and the training batch
# the kernel's timed NLVR2 shapes: the fusion input at both batches in bf16
# (p 0.1 in training, 0 in the eval) and in fp32; and the fine-tuning
# vision stream (L 70) at both batches
NLVR_TIMED = (
    tuple(("fused", b, NLVR_L, "bfloat16", (DROP_P, 0.0), "nlvr")
          for b in NLVR_BATCHES)
    + tuple(("fused", b, NLVR_L, "float32", (0.0,), "nlvr")
            for b in NLVR_BATCHES)
    + tuple(("vis", b, 70, "bfloat16", (DROP_P, 0.0), "key")
            for b in NLVR_BATCHES))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn`. The card first sleeps for about 50 ms,
    long enough for the host to queue all `iters` calls, so that the events
    time the device running them back to back, not the host's enqueue rate
    (at B 96 a call's host work is longer than its kernel)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound_ms(b, lq, lk, dtype_name, bias) -> tuple:
    """(bound ms, 'bytes' | 'operations'): q, k, v, out and the bias read or
    written once, against 4 B H Lq Lk D operations per pass at the type's
    tensor-core peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * H * D * b * (2 * lq + 2 * lk)
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (PASSES[dtype_name] * 4.0 * b * H * lq * lk * D
             / PEAK_FLOPS[dtype_name] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bwd_bound_ms(b, lq, lk, dtype_name, bias) -> tuple:
    """(bound ms, 'bytes' | 'operations') of the backward: q, k, v, the
    output's grad and the bias read once, dq, dk, dv written once, against
    10 B H Lq Lk D operations per pass (q.k^T again, g.v^T, p^T.g, ds.k,
    ds^T.q)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * H * D * b * (3 * lq + 4 * lk)
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (PASSES[dtype_name] * 10.0 * b * H * lq * lk * D
             / PEAK_FLOPS[dtype_name] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(path) -> dict:
    """Kernel name -> its ptxas lines (registers, spills) from the build."""
    report, name = {}, None
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("registers" in line or "spill" in line):
                report.setdefault(name, []).append(
                    " ".join(line.replace("ptxas info    :", "").split()))
    return report


def nlvr_key_mask(torch, gen, b):
    """[b, 140] int32 key mask of the NLVR fusion input: the text and each
    image's regions padded to random lengths, so that masked keys sit inside
    the sequence and, in most rows, fill the second key tile (keys 128-139,
    the second image's last 12 regions)."""
    parts = []
    for n, low in ((NLVR_LA, 8), (NLVR_R, 10), (NLVR_R, 10)):
        lens = torch.randint(low, n + 1, (b,), device=DEVICE, generator=gen)
        parts.append(torch.arange(n, device=DEVICE)[None, :] < lens[:, None])
    return torch.cat(parts, 1).to(torch.int32)


def kernel_key(name: str) -> str:
    """A kernel's mangled name without its unnamed namespace, which carries
    the name and a hash of its translation unit: the same instantiation has
    the same key in every unit and every build."""
    digits = len(name) - len(name[3:].lstrip("0123456789")) - 3
    return name[3 + digits + int(name[3:3 + digits]):]


def phase1_kernel_report(torch, attn, kernels_mod, lib_path):
    """Registers, tensor-core instructions and resident blocks per SM of
    every kernel; fails unless each bf16 and each fp32 (3xTF32) kernel has
    HMMA/HGMMA in its SASS (TF32 shows as HMMA.1684.F32.TF32) and each
    dropout instantiation has as many as its p = 0 twin (in another
    translation unit). Kernels are listed by `kernel_key`, so that builds
    compare line by line."""
    ptxas = {kernel_key(n): v for n, v in ptxas_report(
        os.path.join(kernels_mod.BUILD, "ptxas.log")).items()}
    sass = {kernel_key(n): v
            for n, v in kernels_mod.sass_mma_counts(lib_path).items()}
    names = sorted(n for n in set(ptxas) | set(sass) if "masked_attention" in n)
    log(f"  {len(names)} kernels")
    for name in names:
        log(f"  {name}: HMMA/HGMMA={sass.get(name, 'missing')}  "
            + "  ".join(ptxas.get(name, ["no ptxas report"])))
    for dn, key in (("bf16", "masked_attention_mma"),
                    ("fp32", "masked_attention_3xtf32")):
        tc = [n for n in names if key in n]
        if not tc or any(sass.get(n, 0) == 0 for n in tc):
            raise AssertionError(
                f"a {dn} kernel has no tensor-core instruction in its SASS: "
                f"{[(n, sass.get(n)) for n in tc]}")
    # each dropout instantiation (template argument kDrop = true, "Lb1E" in
    # the mangled name) runs the same products as its p = 0 twin
    drops = [n for n in names if "Lb1EE" in n]
    if len(drops) != len(names) // 2:
        raise AssertionError(f"{len(drops)} dropout kernels of {len(names)}")
    for n in drops:
        twin = n.replace("Lb1EE", "Lb0EE")
        if sass.get(n) != sass.get(twin) or twin not in sass:
            raise AssertionError(f"dropout kernel {n} has {sass.get(n)} "
                                 f"HMMA, its p = 0 twin {sass.get(twin)}")
    for dn, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        log(f"  resident blocks per SM, {dn}, D {D}, fp32 bias: "
            f"{attn.kernel_blocks_per_sm(dt, D)}")


def phase2_kernel_vs_plain(torch, attn):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(b, lq, lk, dt, layout, d=D, exact=False):
        """q, k, v; with `exact`, q and k in multiples of 1/8 so that q.k is
        exact in every summation order (a fully-masked fp32 row keeps only 10
        fraction bits next to the -10000 bias, where two correct orders may
        round a score to neighbouring values)."""
        def one(l, quantize):
            x = torch.randn(b, l, H, d, device="cuda", generator=gen)
            if quantize:
                x = torch.clamp(torch.round(x * 8) / 8, -4, 4)
            x = x.to(dt)
            return x if layout == "blhd" else x.transpose(1, 2).contiguous()
        return one(lq, exact), one(lk, exact), one(lk, False)

    def key_mask(b, lk, full_row=False):
        lens = torch.randint(lk // 2, lk + 1, (b,), device="cuda",
                             generator=gen)
        mask = (torch.arange(lk, device="cuda")[None, :] < lens[:, None])
        mask = mask.to(torch.int32)
        if full_row:
            mask[0] = 0
        return mask

    def query_mask(b, lq, lk, full_row=False):
        mask = (torch.rand(b, lq, lk, device="cuda", generator=gen) > 0.3)
        mask = mask.to(torch.int32)
        mask[..., 0] = 1
        if full_row:
            mask[:, lq // 2] = 0
        return mask

    cases = []
    for name, l in LENGTHS.items():
        for b in (1000, 8):
            for dn in dtypes:
                for layout in ("bhld", "blhd"):
                    cases.append((f"{name} 2-D padded keys", b, l, l, dn,
                                  layout, "key", D, "float32"))
    for dn in dtypes:
        for layout in ("bhld", "blhd"):
            cases += [
                ("fused 3-D mask", 1000, 125, 125, dn, layout, "query", D, "float32"),
                ("Lk>Lq 75/125", 1000, 75, 125, dn, layout, "key", D, "float32"),
                ("fully-masked rows 2-D", 8, 125, 125, dn, layout, "key_full", D, "float32"),
                ("fully-masked rows 3-D", 8, 125, 125, dn, layout, "query_full", D, "float32"),
                ("bf16 bias", 8, 125, 125, dn, layout, "key", D, "bfloat16"),
                ("D=32", 8, 125, 125, dn, layout, "key", 32, "float32"),
                ("D=128", 8, 125, 125, dn, layout, "query", 128, "float32"),
                ("no bias", 8, 70, 70, dn, layout, None, D, "float32"),
                ("Lk>128 75/200", 8, 75, 200, dn, layout, "key", D, "float32"),
                ("Lq>128 160/160", 8, 160, 160, dn, layout, "query", D, "float32"),
                ("B=1", 1, 125, 125, dn, layout, "key", D, "float32"),
                ("odd 17/129", 8, 17, 129, dn, layout, "key", D, "float32"),
                ("odd 1/1", 8, 1, 1, dn, layout, None, D, "float32"),
            ]
            cases += [("nlvr fused 2-D padded keys", b, NLVR_L, NLVR_L, dn,
                       layout, "nlvr", D, "float32") for b in NLVR_BATCHES]
    errors = {}
    for label, b, lq, lk, dn, layout, mk, d, bias_dt in cases:
        q, k, v = qkv(b, lq, lk, dtypes[dn], layout, d,
                      exact=bool(mk) and mk.endswith("_full"))
        if mk is None:
            bias = None
        elif mk == "nlvr":
            bias = attn.mask_to_bias(nlvr_key_mask(torch, gen, b))
        elif mk.startswith("key"):
            bias = attn.mask_to_bias(key_mask(b, lk, mk == "key_full"))
        else:
            bias = attn.mask_to_bias(query_mask(b, lq, lk, mk == "query_full"))
        if bias is not None:
            bias = bias.to(dtypes[bias_dt])
        plain = (attn.plain_attention_blhd if layout == "blhd"
                 else attn.plain_attention)
        got = attn.masked_attention(q, k, v, bias, layout=layout)
        want = plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got.float()).all())
        ok = finite and err <= TOL[dn]
        log(f"  kernel vs plain  {label:24s} B={b:<5d} Lq={lq:<4d} Lk={lk:<4d} "
            f"D={d:<4d} {dn:9s} {layout}  max|err|={err:.3e}  "
            f"tol={TOL[dn]:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {label} "
                                 f"{dn} {layout} err={err} finite={finite}")
        errors[(label, b, dn, layout)] = err
        del q, k, v, bias, got, want

    timings = {}
    for name, l in LENGTHS.items():
        for dn in dtypes:
            b = MAIN_BATCH[name]
            q, k, v = qkv(b, l, l, dtypes[dn], "blhd")
            bias = attn.mask_to_bias(key_mask(b, l))
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            mask_lib = bias.to(dtypes[dn])
            ms = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                       layout="blhd"))
            plain_ms = cuda_ms(lambda: attn.plain_attention_blhd(q, k, v, bias))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib))
            lib_err = (F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib).transpose(1, 2).float()
                - attn.plain_attention_blhd(q, k, v, bias).float()
            ).abs().max().item()
            bound, by = attention_bound_ms(b, l, l, dn, bias)
            timings[(name, dn)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound,
                                       bound_by=by)
            log(f"  time {name:5s} B={b} L={l} {dn:9s} blhd: kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
                f"(|sdpa-plain| {lib_err:.2e})  bound {bound:.4f} ms ({by})  "
                f"bound/kernel {bound / ms:.3f}  kernel/sdpa {ms / lib_ms:.3f}")
            del q, k, v, bias, qh, kh, vh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errors, timings


def phase2_backward(torch, attn):
    """MaskedAttentionFn's grads against fp32 autograd of the plain version
    at the training shapes, and the forward/backward times."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(l, dt, layout, mask_kind):
        x = [torch.randn(TRAIN_B, l, H, D, device=DEVICE, generator=gen)
             .to(dt) for _ in range(4)]              # q, k, v, grad of out
        if layout == "bhld":
            x = [t.transpose(1, 2).contiguous() for t in x]
        lens = torch.randint(l // 2, l + 1, (TRAIN_B,), device=DEVICE,
                             generator=gen)
        if mask_kind == "query":
            mask = (torch.rand(TRAIN_B, l, l, device=DEVICE, generator=gen)
                    > 0.3).to(torch.int32)
            mask[..., 0] = 1
            mask[:, l // 2] = 0                      # a fully-masked row
        else:
            mask = (torch.arange(l, device=DEVICE)[None, :]
                    < lens[:, None]).to(torch.int32)
            mask[0] = 0                              # a fully-masked row
        return x, attn.mask_to_bias(mask)

    errs = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            for layout in ("blhd", "bhld"):
                for mk in (("key", "query") if name == "fused" else ("key",)):
                    (q, k, v, g), bias = inputs(l, dt, layout, mk)
                    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
                    before = attn.masked_attention.launches
                    out = attn.masked_attention(q, k, v, bias, layout=layout)
                    if not isinstance(out.grad_fn,
                                      attn.MaskedAttentionFn._backward_cls):
                        raise AssertionError("kernel output has no grad_fn")
                    got = torch.autograd.grad(out, leaves, g)
                    ref_in = [t.detach().float().requires_grad_()
                              for t in leaves]
                    plain = (attn.plain_attention_blhd if layout == "blhd"
                             else attn.plain_attention)
                    want = torch.autograd.grad(plain(*ref_in), ref_in,
                                               g.float())
                    torch.cuda.synchronize()
                    if attn.masked_attention.launches != before + 1:
                        raise AssertionError("the backward launched a kernel")
                    err = max((a.float() - b).abs().max().item()
                              for a, b in zip(got, want))
                    finite = all(bool(torch.isfinite(a).all()) for a in got)
                    ok = finite and err <= GRAD_TOL[dn]
                    log(f"  grads vs plain   {name:5s} {mk:5s} B={TRAIN_B} "
                        f"L={l:<4d} {dn:9s} {layout}  max|err|={err:.3e}  "
                        f"tol={GRAD_TOL[dn]:g}  {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"attention grads disagree: {name} {mk} {dn} "
                            f"{layout} err={err} finite={finite}")
                    errs[(name, dn, layout, mk)] = err
                    del q, k, v, g, bias, leaves, out, got, ref_in, want

    timings = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            (q, k, v, g), bias = inputs(l, dt, "blhd", "key")
            qkv = [t.requires_grad_() for t in (q, k, v)]
            out = attn.masked_attention(*qkv, bias, layout="blhd")
            fwd = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                        layout="blhd"))
            bwd = cuda_ms(lambda: torch.autograd.grad(out, qkv, g,
                                                      retain_graph=True))
            plain_fwd = cuda_ms(lambda: attn.plain_attention_blhd(
                q, k, v, bias), iters=5)
            p_out = attn.plain_attention_blhd(*qkv, bias)
            plain_bwd = cuda_ms(lambda: torch.autograd.grad(
                p_out, qkv, g, retain_graph=True))
            qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask_lib = bias.to(dt)
            sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib))
            gh = g.transpose(1, 2)
            sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask_lib),
                (qh, kh, vh), gh))
            bound, by = attention_bwd_bound_ms(TRAIN_B, l, l, dn, bias)
            fwd_bound, fwd_by = attention_bound_ms(TRAIN_B, l, l, dn, bias)
            timings[(name, dn)] = dict(
                fwd_ms=fwd, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                plain_fwd_ms=plain_fwd, bwd_ms=bwd, plain_bwd_ms=plain_bwd,
                sdpa_fwd_ms=sdpa_fwd, sdpa_fwd_bwd_ms=sdpa_fb,
                bwd_bound_ms=bound, bwd_bound_by=by,
                grad_err=max(v for k_, v in errs.items()
                             if k_[:2] == (name, dn)))
            log(f"  time train {name:5s} B={TRAIN_B} L={l} {dn:9s} blhd: "
                f"kernel fwd {fwd:.4f} ms (bound {fwd_bound:.4f}, {fwd_by}; "
                f"kernel/sdpa {fwd / sdpa_fwd:.3f})  "
                f"plain fwd {plain_fwd:.4f} ms  recompute bwd {bwd:.4f} ms  "
                f"plain bwd {plain_bwd:.4f} ms  sdpa fwd {sdpa_fwd:.4f} ms  "
                f"sdpa fwd+bwd {sdpa_fb:.4f} ms  bwd bound {bound:.4f} ms "
                f"({by})")
            del q, k, v, g, bias, qkv, out, p_out, qh, kh, vh, gh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timings


def online_mask_readback(torch, attn, b, l, dn, dt, layout, seed) -> dict:
    """The dropout kernel's mask at Lq = Lk = l (the online kernels past 128
    keys), read back bit for bit: q = k = 0 gives every key 1/l, v one-hot
    over a window of D keys; the windows (one launch each, the same seed)
    read back all l columns. Fails unless it equals the plain hash's mask,
    its keep share is within KEEP_SHARE_TOL of 1 - p and every kept value is
    1/(l (1 - p))."""
    value = 1.0 / l / (1.0 - DROP_P)
    q = torch.zeros(b, H, l, D, device=DEVICE, dtype=dt)
    got = torch.zeros(b, H, l, l, dtype=torch.bool, device=DEVICE)
    rel = 0.0
    before = attn.masked_attention.dropout_launches
    windows = range(0, l, D)
    for off in windows:
        n = min(D, l - off)
        v = torch.zeros(b, H, l, D, device=DEVICE, dtype=dt)
        v[:, :, off:off + n, :n] = torch.eye(n, device=DEVICE, dtype=dt)
        qkv = (q, q, v)
        if layout == "blhd":
            qkv = tuple(t.transpose(1, 2).contiguous() for t in qkv)
        out = attn.masked_attention(*qkv, layout=layout, dropout_p=DROP_P,
                                    seed=seed)
        if layout == "blhd":
            out = out.transpose(1, 2)
        out = out[..., :n].float()
        got[..., off:off + n] = out > 0
        if bool((out > 0).any()):
            rel = max(rel, ((out[out > 0] - value).abs().max()
                            / value).item())
        del v, out
    torch.cuda.synchronize()
    launched = attn.masked_attention.dropout_launches - before
    want = attn.dropout_keep(seed, DROP_P, (b, H, l, l))
    mismatched = int((got != want).sum())
    share = got.float().mean().item()
    rel_tol = 2.0 ** -7 if dn == "bfloat16" else 1e-5
    ok = (launched == len(windows) and mismatched == 0 and rel <= rel_tol
          and abs(share - (1 - DROP_P)) <= KEEP_SHARE_TOL)
    log(f"  dropout mask     {dn:9s} {layout}  B={b} Lq={l} Lk={l} "
        f"(online kernel, {launched} launches): {got.numel()} elements, "
        f"{mismatched} differ from the plain hash, keep share {share:.6f} "
        f"(want {1 - DROP_P} +- {KEEP_SHARE_TOL}), kept values within "
        f"{rel:.2e} of 1/(Lk (1-p)) (tol {rel_tol:.1e})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dropout mask at Lk {l} {dn} {layout}: "
                             f"{mismatched} differ, share {share}, rel {rel}, "
                             f"{launched} launches")
    return dict(elements=got.numel(), mismatched=mismatched, keep_share=share,
                rel=rel, launches=launched)


def phase2_dropout(torch, attn):
    """Attention-prob dropout inside the kernel: the mask read back bit for
    bit, the dropout kernel and its backward against the plain dropout
    version at the training shapes, and its time beside the p = 0 kernel and
    SDPA with the same dropout."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def new_seed():
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=DEVICE, generator=gen)

    # the mask: q = k = 0 gives uniform probabilities 1/64 over Lk = D = 64
    # keys, v = I per (b, h) copies each probability to its own dim
    lq, lk = LENGTHS["fused"], D
    for dn, dt in dtypes.items():
        for layout in ("bhld", "blhd"):
            seed = new_seed()
            q = torch.zeros(TRAIN_B, H, lq, D, device=DEVICE, dtype=dt)
            k = torch.zeros(TRAIN_B, H, lk, D, device=DEVICE, dtype=dt)
            v = torch.eye(lk, device=DEVICE, dtype=dt).expand(
                TRAIN_B, H, lk, D).contiguous()
            if layout == "blhd":
                q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            before = attn.masked_attention.dropout_launches
            out = attn.masked_attention(q, k, v, layout=layout,
                                        dropout_p=DROP_P, seed=seed)
            torch.cuda.synchronize()
            if attn.masked_attention.dropout_launches != before + 1:
                raise AssertionError("the dropout kernel was not launched")
            if layout == "blhd":
                out = out.transpose(1, 2)
            got = out > 0
            want = attn.dropout_keep(seed, DROP_P, (TRAIN_B, H, lq, lk))
            mismatched = int((got != want).sum())
            share = got.float().mean().item()
            value = torch.tensor(1.0 / lk / (1.0 - DROP_P)).to(dt).float()
            bad_value = int((out.float()[got] != value.to(DEVICE)).sum())
            ok = (mismatched == 0 and bad_value == 0
                  and abs(share - (1 - DROP_P)) <= KEEP_SHARE_TOL)
            log(f"  dropout mask     {dn:9s} {layout}  B={TRAIN_B} Lq={lq} "
                f"Lk={lk}: {got.numel()} elements, {mismatched} differ from "
                f"the plain hash, keep share {share:.6f} "
                f"(want {1 - DROP_P} +- {KEEP_SHARE_TOL}), {bad_value} kept "
                f"values off 1/(Lk (1-p))  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"dropout mask {dn} {layout}: "
                                     f"{mismatched} differ, share {share}")
            del q, k, v, out, got, want

    # at Lk 140 (NLVR's fusion input: the online kernels, two key tiles and
    # two query tiles)
    for dn, dt in dtypes.items():
        for layout in ("bhld", "blhd"):
            online_mask_readback(torch, attn, NLVR_BATCHES[1], NLVR_L, dn,
                                 dt, layout, new_seed())

    def inputs(l, dt, layout, b=TRAIN_B, nlvr=False):
        x = [torch.randn(b, l, H, D, device=DEVICE, generator=gen)
             for _ in range(4)]                      # q, k, v, grad of out
        # q and k in multiples of 1/8: q.k is exact in every summation order,
        # as the fully-masked fp32 row needs (phase2_kernel_vs_plain's qkv)
        x[:2] = [torch.clamp(torch.round(t * 8) / 8, -4, 4) for t in x[:2]]
        x = [t.to(dt) for t in x]
        if layout == "bhld":
            x = [t.transpose(1, 2).contiguous() for t in x]
        if nlvr:
            mask = nlvr_key_mask(torch, gen, b)
        else:
            lens = torch.randint(l // 2, l + 1, (b,), device=DEVICE,
                                 generator=gen)
            mask = (torch.arange(l, device=DEVICE)[None, :]
                    < lens[:, None]).to(torch.int32)
        mask[0] = 0                                  # a fully-masked row
        return x, attn.mask_to_bias(mask)

    shapes = [(name, TRAIN_B, l, False) for name, l in LENGTHS.items()]
    shapes += [(f"nlvr B {b}", b, NLVR_L, True) for b in NLVR_BATCHES]
    errs = {}
    for name, b, l, nlvr in shapes:
        for dn, dt in dtypes.items():
            for layout in ("blhd", "bhld"):
                (q, k, v, g), bias = inputs(l, dt, layout, b, nlvr)
                seed = new_seed()
                plain = (attn.plain_attention_blhd if layout == "blhd"
                         else attn.plain_attention)
                leaves = [t.requires_grad_() for t in (q, k, v, bias)]
                out = attn.masked_attention(*leaves[:3], leaves[3],
                                            layout=layout, dropout_p=DROP_P,
                                            seed=seed)
                want = plain(q.detach(), k.detach(), v.detach(), bias.detach(),
                             DROP_P, seed)
                got_g = torch.autograd.grad(out, leaves, g)
                ref_in = [t.detach().float().requires_grad_() for t in leaves]
                want_g = torch.autograd.grad(plain(*ref_in, DROP_P, seed),
                                             ref_in, g.float())
                torch.cuda.synchronize()
                f_err = (out.float() - want.float()).abs().max().item()
                b_err = max((a.float() - b).abs().max().item()
                            for a, b in zip(got_g, want_g))
                finite = (bool(torch.isfinite(out.float()).all())
                          and all(bool(torch.isfinite(a).all())
                                  for a in got_g))
                ok = finite and f_err <= TOL[dn] and b_err <= GRAD_TOL[dn]
                log(f"  dropout vs plain {name:5s} B={b} L={l:<4d} "
                    f"{dn:9s} {layout}  fwd max|err|={f_err:.3e} "
                    f"(tol {TOL[dn]:g})  grads max|err|={b_err:.3e} "
                    f"(tol {GRAD_TOL[dn]:g})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"dropout kernel disagrees: {name} {dn} {layout} "
                        f"fwd {f_err} grads {b_err} finite={finite}")
                errs[(name, dn, layout)] = (f_err, b_err)
                del q, k, v, g, bias, leaves, out, want, got_g, ref_in, want_g

    timings = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            (q, k, v, _), bias = inputs(l, dt, "blhd")
            seed = new_seed()
            drop_ms = cuda_ms(lambda: attn.masked_attention(
                q, k, v, bias, layout="blhd", dropout_p=DROP_P, seed=seed))
            p0_ms = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                          layout="blhd"))
            plain_ms = cuda_ms(lambda: attn.plain_attention_blhd(
                q, k, v, bias, DROP_P, seed), iters=5)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            mask_lib = bias.to(dt)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib, dropout_p=DROP_P))
            # the recompute backward with and without the mask regeneration
            qkv = [t.requires_grad_() for t in (q, k, v)]
            g = torch.randn_like(q)
            out_d = attn.masked_attention(*qkv, bias, layout="blhd",
                                          dropout_p=DROP_P, seed=seed)
            out_0 = attn.masked_attention(*qkv, bias, layout="blhd")
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                out_d, qkv, g, retain_graph=True), iters=5)
            bwd_p0_ms = cuda_ms(lambda: torch.autograd.grad(
                out_0, qkv, g, retain_graph=True), iters=5)
            bound, by = attention_bound_ms(TRAIN_B, l, l, dn, bias)
            timings[(name, dn)] = dict(
                ms=drop_ms, p0_ms=p0_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                bound_ms=bound, bound_by=by, bwd_ms=bwd_ms,
                bwd_p0_ms=bwd_p0_ms,
                max_abs_err=max(errs[(name, dn, lay)][0]
                                for lay in ("blhd", "bhld")))
            log(f"  time dropout {name:5s} B={TRAIN_B} L={l} {dn:9s} blhd: "
                f"kernel p=0.1 {drop_ms:.4f} ms  p=0 {p0_ms:.4f} ms "
                f"(ratio {drop_ms / p0_ms:.3f})  plain {plain_ms:.4f} ms  "
                f"sdpa p=0.1 {sdpa_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                f"recompute bwd p=0.1 {bwd_ms:.4f} ms  p=0 {bwd_p0_ms:.4f} ms")
            del q, k, v, g, qkv, out_d, out_0, bias, qh, kh, vh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timings


def bench_inputs(torch, cfg, n_img, cpi, la, t, r, seed=0):
    """The bench geometry's inputs (bench.py:99-123), made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n_cap = n_img * cpi
    caps = dict(
        input_ids_a=torch.randint(0, cfg.only_word_size, (n_cap, la),
                                  device=DEVICE, generator=gen),
        attention_mask_a=torch.ones(n_cap, la, dtype=torch.int32,
                                    device=DEVICE),
        token_type_ids_a=torch.zeros(n_cap, la, dtype=torch.int64,
                                     device=DEVICE))
    imgs = dict(
        input_ids_b=torch.randint(0, cfg.only_word_size, (n_img, t),
                                  device=DEVICE, generator=gen),
        attention_mask_b=torch.ones(n_img, t + r, dtype=torch.int32,
                                    device=DEVICE),
        token_type_ids_b=torch.ones(n_img, t, dtype=torch.int64,
                                    device=DEVICE),
        img_feats=torch.randn(n_img, r, cfg.img_feature_dim, device=DEVICE,
                              generator=gen))
    return caps, imgs


def base_config(ModelConfig, dtype, dropout=0.0, **kw):
    """MVPTR-base with the 86,051-row vocabulary (__graft_entry__.py:25-30);
    `dropout` sets both dropouts (the config's default is 0.1)."""
    return ModelConfig(vocab_size=86051, only_word_size=30522, dtype=dtype,
                       hidden_dropout_prob=dropout,
                       attention_probs_dropout_prob=dropout, **kw)


def phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                     two_stage_scoring, dtype="bfloat16", reps=2):
    """`reps` full sweeps at the bench geometry in `dtype`, after a warm-up
    on a subset; each must launch the kernel exactly 492 times. Returns the
    last sweep's launches, the pairs/s of every sweep and the peak memory."""
    n_img, cpi, la, t, r = 1000, 5, 75, 20, 50
    k_i2t, k_t2i, eb, sb = 20, 10, 500, 1000
    cfg = base_config(ModelConfig, dtype)
    assert (cfg.hidden_size, cfg.half_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.img_feature_dim) == (768, 6, 12, 3072,
                                                             2054)
    t0 = time.perf_counter()
    model = RetrievalModel(cfg, device="cuda", seed=0)
    caps, imgs = bench_inputs(torch, cfg, n_img, cpi, la, t, r)
    torch.cuda.synchronize()
    log(f"  {dtype}: model + inputs ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")

    # warm-up at the same batch shapes on a subset (excluded from the count)
    sub = 500
    two_stage_scoring(model, {k: v[:sub * cpi] for k, v in caps.items()},
                      {k: v[:sub] for k, v in imgs.items()}, cpi, k_i2t,
                      k_t2i, eb, sb, max_tag_length=t)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    pairs_per_s = []
    for rep in range(reps):
        attn.masked_attention.launches = 0
        res = two_stage_scoring(model, caps, imgs, cpi, k_i2t, k_t2i, eb, sb,
                                max_tag_length=t)
        torch.cuda.synchronize()
        launches = attn.masked_attention.launches
        n_enc_batches = math.ceil(n_img * cpi / eb) + math.ceil(n_img / eb)
        n_pair_batches = math.ceil(res["n_pairs"] / sb)
        want = cfg.half_layers * (n_enc_batches + n_pair_batches)
        sec = res["seconds"]
        sweep = sum(sec[s] for s in ("encode_text", "encode_image", "coarse",
                                     "rerank"))
        pairs_per_s.append(res["n_pairs"] / sweep)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  two-stage {dtype} run {rep + 1}: pairs={res['n_pairs']} "
            f"launches={launches} (want {want})  "
            + "  ".join(f"{s}={v:.4f}s" for s, v in sec.items())
            + f"  sweep={sweep:.4f}s  pairs/s={pairs_per_s[-1]:.1f}"
            + f"  peak_mem={peak:.2f}GB")
        if launches != want or want != 492:
            raise AssertionError(f"masked_attention launched {launches} "
                                 f"times, want {want} (= 492)")
        scores = res["scores"]
        if (scores.shape != (n_img * k_i2t + n_img * cpi * k_t2i,)
                or not np.isfinite(scores).all()
                or scores.min() < 0 or scores.max() > 1):
            raise AssertionError("rerank scores malformed")
        if (res["i2t_cands"].shape != (n_img, k_i2t)
                or res["t2i_cands"].shape != (n_img * cpi, k_t2i)):
            raise AssertionError("candidate lists malformed")
        log(f"    coarse {json.dumps(res['coarse'])}")
        log(f"    fine   {json.dumps(res['fine'])}")
    del model, caps, imgs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(launches=launches, pairs_per_s=pairs_per_s, peak_gb=peak)


@contextlib.contextmanager
def plain_attention_path(layers_mod, attn):
    """Route the model's attention through the plain version (on the card)."""
    def plain(q, k, v, bias=None, *, layout="bhld", dropout_p=0.0, seed=None):
        fn = (attn.plain_attention_blhd if layout == "blhd"
              else attn.plain_attention)
        return fn(q, k, v, bias, dropout_p, seed)
    saved = layers_mod.masked_attention
    layers_mod.masked_attention = plain
    try:
        yield
    finally:
        layers_mod.masked_attention = saved


def phase4_end_to_end(torch, attn, layers_mod, ModelConfig, RetrievalModel):
    n_img, cpi, la, t, r = 6, 2, 75, 20, 50
    for dn in ("float32", "bfloat16"):
        cfg = base_config(ModelConfig, dn)
        model = RetrievalModel(cfg, device="cuda", seed=0)
        caps, imgs = bench_inputs(torch, cfg, n_img, cpi, la, t, r, seed=3)
        caps["attention_mask_a"][1::2, 60:] = 0      # padded captions
        imgs["attention_mask_b"][1::2, t + 40:] = 0  # padded regions
        ca = [caps[k] for k in ("input_ids_a", "attention_mask_a",
                                "token_type_ids_a")]
        ib = [imgs[k] for k in ("input_ids_b", "attention_mask_b",
                                "token_type_ids_b", "img_feats")]
        cap_idx = torch.arange(n_img * cpi, device="cuda")
        img_idx = cap_idx % n_img                    # true and false pairs

        def run():
            with torch.inference_mode():
                ts, tg = model.encode_text_full(*ca)
                vp, vm, ig = model.encode_image_full(*ib, max_tag_length=t)
                logits = model.score_cached(ts[cap_idx], ca[1][cap_idx],
                                            vp[img_idx], vm[img_idx])
                return torch.softmax(logits, -1)[:, 1], tg, ig

        before = attn.masked_attention.launches
        k_out = run()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != 3 * cfg.half_layers:
            raise AssertionError("kernel path did not launch the kernel")
        with plain_attention_path(layers_mod, attn):
            p_out = run()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != 3 * cfg.half_layers:
            raise AssertionError("plain path launched the kernel")
        for name, a, b in zip(("itm_prob", "txt_glob", "img_glob"), k_out,
                              p_out):
            err = (a.float() - b.float()).abs().max().item()
            ok = bool(torch.isfinite(a).all()) and err <= E2E_TOL[dn]
            log(f"  end to end {dn:9s} {name:9s} shape={tuple(a.shape)} "
                f"max|kernel-plain|={err:.3e} tol={E2E_TOL[dn]:g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"end to end {dn} {name}: {err}")
        del model, caps, imgs, k_out, p_out
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def train_batch(torch, cfg, seed):
    """One padded batch of true pairs at the training geometry."""
    t = 20
    caps, imgs = bench_inputs(torch, cfg, TRAIN_B, 1, 75, t, 50, seed=seed)
    caps["attention_mask_a"][1::2, 60:] = 0          # padded captions
    imgs["attention_mask_b"][1::2, t + 40:] = 0      # padded regions
    return {**caps, **imgs}


@contextlib.contextmanager
def hard_pairs(model, pinned=None):
    """Record the hard pairs the model mines, or make it take `pinned`
    instead (an instance override of `mine_hard_negatives`). The real mining
    runs either way, so that it takes the same draws from the generator and
    the dropout masks after it stay the same."""
    record, real = [], model.bert.mine_hard_negatives

    def mine(*args, **kw):
        mined = real(*args, **kw)
        record.append(pinned if pinned is not None else mined)
        return record[-1]
    model.bert.mine_hard_negatives = mine
    try:
        yield record
    finally:
        del model.bert.mine_hard_negatives


def reset_counts(attn):
    attn.masked_attention.launches = 0
    attn.masked_attention.dropout_launches = 0
    attn.plain_attention.calls = 0


def check_counts(attn, want, what):
    """Every launch since `reset_counts` was the dropout instantiation, there
    were `want` of them, and the plain version never ran."""
    got = attn.masked_attention.launches
    drop = attn.masked_attention.dropout_launches
    plain = attn.plain_attention.calls
    if got != want or drop != want or plain != 0:
        raise AssertionError(f"{what} launched the kernel {got} times ({drop} "
                             f"with dropout) and the plain version {plain} "
                             f"times; want {want}, {want} and 0")


def timed_steps(torch, attn, trainer, batch, per_step):
    """TRAIN_TIMED Trainer steps, each of which must launch the dropout
    kernel `per_step` times and the plain version never. Returns the
    metrics, the launches and the seconds per step."""
    torch.cuda.reset_peak_memory_stats()
    history, launches = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        reset_counts(attn)
        history.append(trainer.step(batch))     # ends in a device sync
        check_counts(attn, per_step, "a training step")
        launches += attn.masked_attention.launches
    torch.cuda.synchronize()
    return history, launches, (time.perf_counter() - t0) / TRAIN_TIMED


def compare_step(torch, what, dn, k_out, p_out, loss_names, k_grads, p_grads):
    """One step's kernel path against its plain path: each loss within
    STEP_TOL's loss tolerance, each named gradient within its relative
    tolerance."""
    loss_tol, grad_tol = STEP_TOL[dn]
    for name in loss_names:
        a = getattr(k_out, name).item()
        b = getattr(p_out, name).item()
        ok = math.isfinite(a) and abs(a - b) <= loss_tol
        log(f"  {what} {dn:9s} {name:14s} kernel={a:.6f} plain={b:.6f} "
            f"|diff|={abs(a - b):.3e} tol={loss_tol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} {dn} {name}: {a} vs {b}")
    for name in k_grads:
        a, b = k_grads[name].float(), p_grads[name].float()
        rel = ((a - b).norm() / b.norm()).item()
        ok = bool(torch.isfinite(a).all()) and rel <= grad_tol
        log(f"  {what} {dn:9s} grad {name}: |g|={b.norm().item():.4e} "
            f"rel err={rel:.3e} tol={grad_tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} {dn} grad {name}: {rel}")


def phase5_training(torch, attn, layers_mod, ModelConfig, RetrievalModel):
    from mvp_pytorch_tpu_torch.tasks.retrieval import (retrieval_loss_fn,
                                                       train_retrieval)
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    cfg = base_config(ModelConfig, "bfloat16", DROP_P)
    per_step = cfg.half_layers * 4       # txt + vis + 2 fusion passes
    model = RetrievalModel(cfg, device=DEVICE, seed=0)
    batch = train_batch(torch, cfg, seed=5)
    torch.cuda.synchronize()
    opt_kw = dict(schedule="constant", max_grad_norm=1.0)

    reset_counts(attn)
    warm = train_retrieval(model, [batch], TRAIN_WARMUP, learning_rate=4e-5,
                           max_tag_length=20, hn_mod="hard", logger=log,
                           log_period=1, **opt_kw)
    torch.cuda.synchronize()
    check_counts(attn, per_step * TRAIN_WARMUP, "train_retrieval")

    trainer = Trainer(model, retrieval_loss_fn(max_tag_length=20,
                                               hn_mod="hard"),
                      make_optimizer(model, 4e-5, **opt_kw), seed=1)
    history, launches, step_s = timed_steps(torch, attn, trainer, batch,
                                            per_step)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in warm + history]
    log("  losses " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  last step clip={history[-1]['clip']:.4f} "
        f"itm={history[-1]['itm']:.4f} "
        f"grad_norm={history[-1]['grad_norm']:.4f}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    log(f"  train step B={TRAIN_B} bf16, dropouts {DROP_P}: "
        f"{step_s * 1e3:.2f} ms/step  {TRAIN_B / step_s:.1f} samples/s  "
        f"launches/step={per_step} (all with dropout)  "
        f"peak_mem={peak / 1e9:.2f}GB")
    del trainer, model
    torch.cuda.empty_cache()

    # the same step on both paths: the same generator draws the same
    # dropout masks (hidden: bernoulli_; attention: the kernel's seed and the
    # plain version's hash of it)
    for dn in ("float32", "bfloat16"):
        model = RetrievalModel(base_config(ModelConfig, dn, DROP_P),
                               device=DEVICE, seed=0)
        model.train()
        batch = train_batch(torch, model.config, seed=6)

        def step():
            model.zero_grad(set_to_none=True)
            out = model.train_step(*(batch[k] for k in (
                "input_ids_a", "attention_mask_a", "token_type_ids_a",
                "input_ids_b", "attention_mask_b", "token_type_ids_b",
                "img_feats")), max_tag_length=20, hn_mod="hard",
                generator=torch.Generator(device=DEVICE).manual_seed(0))
            out.total_loss.backward()
            params = dict(model.named_parameters())
            return out, {n: params[n].grad.detach().clone()
                         for n in GRAD_PARAMS}

        before = attn.masked_attention.launches
        with hard_pairs(model) as mined:
            k_out, k_grads = step()
        if attn.masked_attention.launches - before != per_step:
            raise AssertionError("kernel path did not launch the kernel")
        with plain_attention_path(layers_mod, attn), hard_pairs(
                model, pinned=mined[0]):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != per_step:
            raise AssertionError("plain path launched the kernel")
        compare_step(torch, "train step", dn, k_out, p_out,
                     ("total_loss", "retrieval_loss", "itm_loss"), k_grads,
                     p_grads)
        del model, batch, k_out, p_out, k_grads, p_grads
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return dict(step_ms=step_s * 1e3, samples_per_s=TRAIN_B / step_s,
                peak_gb=peak / 1e9, launches_per_step=per_step,
                launches=launches, losses=losses)


QA_ANSWERS = 3129                    # VQA v2's answer set


def pretrain_batch(torch, cfg, seed, qa=False):
    """bench.py's pretraining batch (bench.py:416-440) made on the card:
    `train_batch`'s padded captions and images, 8 labelled text positions
    and 3 labelled tag positions, phrase span [9, 14) and image span
    [75, 125); with `qa`, answers and QA-pair labels with -1 rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1000)
    batch = train_batch(torch, cfg, seed)
    b, la = batch["input_ids_a"].shape
    tr = batch["attention_mask_b"].shape[1]                # tags + regions

    def labels(width, pos):
        lab = torch.full((b, width), -1, dtype=torch.int64, device=DEVICE)
        lab[:, pos] = torch.randint(0, cfg.only_word_size,
                                    (b, pos.stop - pos.start), device=DEVICE,
                                    generator=gen)
        return lab
    batch.update(
        lm_label_ids_a=labels(la, slice(1, 9)),
        lm_label_ids_b=labels(tr, slice(1, 4)),
        phrase_index=torch.tensor([[9, 14]], device=DEVICE).repeat(b, 1),
        # the fused sequence is [text (LA) ; regions (R)]
        image_index=torch.tensor([[la, la + batch["img_feats"].shape[1]]],
                                 device=DEVICE).repeat(b, 1))
    if qa:
        batch["qa_ans"] = torch.randint(0, QA_ANSWERS, (b,), device=DEVICE,
                                        generator=gen)
        batch["qa_ans"][::7] = -1
        batch["qa_is_next"] = torch.randint(0, 2, (b,), device=DEVICE,
                                            generator=gen)
        batch["qa_is_next"][::5] = -1
    return batch


def phase6_pretraining(torch, attn, layers_mod, ModelConfig):
    """`BiPretrainModel` trained at MVPTR-base in bf16 at the config's
    dropouts, then one step at dropouts 0 on both paths."""
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.tasks.pretrain import (PRETRAIN_KEYS,
                                                      pretrain_loss_fn,
                                                      train_pretrain)
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    if ModelConfig().attention_probs_dropout_prob != DROP_P or \
            ModelConfig().hidden_dropout_prob != DROP_P:
        raise AssertionError("the config's default dropouts are not 0.1")
    cfg = base_config(ModelConfig, "bfloat16", DROP_P)
    per_step = cfg.half_layers * 4       # txt + vis + 2 fusion passes
    model = BiPretrainModel(cfg, device=DEVICE, seed=0)
    batch = pretrain_batch(torch, cfg, seed=7)
    torch.cuda.synchronize()
    log(f"  model + batch ready in {time.perf_counter() - t_phase:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    step_kw = dict(max_tag_length=20, hn_mod="hard", phrase_mod="sample",
                   max_pred_a=20, max_pred_b=10)
    opt_kw = dict(schedule="constant", max_grad_norm=1.0)

    reset_counts(attn)
    warm = train_pretrain(model, [batch], TRAIN_WARMUP, learning_rate=1e-4,
                          logger=log, log_period=1, **opt_kw, **step_kw)
    torch.cuda.synchronize()
    check_counts(attn, per_step * TRAIN_WARMUP, "train_pretrain")

    trainer = Trainer(model, pretrain_loss_fn(**step_kw),
                      make_optimizer(model, 1e-4, **opt_kw), seed=1)
    history, launches, step_s = timed_steps(torch, attn, trainer, batch,
                                            per_step)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in warm + history]
    log("  losses " + " ".join(f"{x:.4f}" for x in losses))
    log("  last step " + " ".join(f"{k}={v:.4f}"
                                  for k, v in history[-1].items()))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"pretraining losses not finite and falling: "
                             f"{losses}")
    log(f"  pretrain step B={TRAIN_B} bf16, dropouts {DROP_P}: "
        f"{step_s * 1e3:.2f} ms/step  {TRAIN_B / step_s:.1f} samples/s  "
        f"launches/step={per_step} (all with dropout, plain version 0)  "
        f"peak_mem={peak / 1e9:.2f}GB")
    del trainer, model, batch
    torch.cuda.empty_cache()

    # one step at dropouts 0 with every loss (QA heads on), kernel path
    # against plain path, the draws and the hard pairs pinned
    for dn in ("float32", "bfloat16"):
        cfg0 = base_config(ModelConfig, dn, qa_answer_size=QA_ANSWERS)
        model = BiPretrainModel(cfg0, qa_pairs=True, device=DEVICE, seed=0)
        model.train()
        batch = pretrain_batch(torch, cfg0, seed=8, qa=True)
        dice = torch.randperm(TRAIN_B, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(9))

        def step():
            model.zero_grad(set_to_none=True)
            out = model.train_step(
                *(batch[k] for k in PRETRAIN_KEYS), hn_dice=dice, wra_pick=1,
                wra_neg_offset=1,
                generator=torch.Generator(device=DEVICE).manual_seed(0),
                **step_kw)
            out.total_loss.backward()
            params = dict(model.named_parameters())
            return out, {n: params[n].grad.detach().clone()
                         for n in PRETRAIN_GRAD_PARAMS}

        reset_counts(attn)
        with hard_pairs(model) as mined:
            k_out, k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0):
            raise AssertionError("kernel path did not launch the p = 0 kernel")
        with plain_attention_path(layers_mod, attn), hard_pairs(
                model, pinned=mined[0]):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("plain path launched the kernel")
        compare_step(torch, "pretrain step", dn, k_out, p_out,
                     PRETRAIN_LOSSES, k_grads, p_grads)
        del model, batch, k_out, p_out, k_grads, p_grads
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 6 took {seconds:.1f} s")
    return dict(step_ms=step_s * 1e3, samples_per_s=TRAIN_B / step_s,
                peak_gb=peak / 1e9, launches_per_step=per_step,
                launches=launches, losses=losses, seconds=seconds)


# phase 7: the retrieval command line on a generated root at the real widths
# (bench.py:99-105's Flickr30k test geometry)
CLI_IMAGES, CLI_CAPS, CLI_REGIONS, CLI_TAGS = 1000, 5, 50, 50
CLI_VOCAB, CLI_WORDS_PER_CAP, CLI_PHRASES = 30522, 90, 1000
CLI_MEM_STEPS, CLI_STEPS, CLI_TIMED_FROM = 13, 26, 6   # CLI steps 6-26 timed
CLI_MEM_TIMED_FROM = 4
CLI_ARGS = ["--max_seq_length", "70", "--max_phrases", "5",   # LA 75
            "--max_tag_length", "20", "--max_img_seq_length", "50",
            "--dtype", "bfloat16", "--seed", "11"]
CLI_PLATFORM = []                    # a CPU rehearsal sets ["--platform", "cpu"]
CLI_EVAL_ARGS = ["--eval_batch_size", "500", "--rerank_batch_size", "1000",
                 "--num_captions_per_img_val", "20",
                 "--num_images_per_cap_val", "10"]
SCORE_TOL = 1e-6


def write_cli_root(root, seed=0, corpus=False, finetune=False, nlvr=False,
                   n_images=None):
    """A retrieval root at the real widths, written with the port's own
    `tsv_writer`: a 30,522-word vocab, CLI_IMAGES (or `n_images`) images of
    CLI_REGIONS regions x 2,054 fp32 features and CLI_TAGS tags each
    (predictions.tsv + imageid2idx.json), CLI_CAPS captions an image of
    CLI_WORDS_PER_CAP words (more than LA 75 holds) with phrases from
    id2phrase.json (captions.json). An image's first five tags also open
    each of its captions. With `corpus`, also a pretraining corpus of
    CLI_CAPS rows an image, [image_id, caption, 8 phrases (JSON), answer id,
    answer]: captions as above, every other row a QA pair whose answer is one of the
    image's tags (corpus.tsv), and tag2id.json over the tag words. With
    `finetune`, each region's last 6 feature dims are a valid box [x1, y1,
    x2, y2, w, h] and `write_finetune_files` adds the VQA, SNLI-VE and RE
    files; with `nlvr`, `write_nlvr_files` adds NLVR2 statements. Returns
    the paths and the bytes written."""
    import base64
    from mvp_pytorch_tpu_torch.data.tsv import tsv_writer
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = [f"w{i}" for i in range(CLI_VOCAB - len(specials))]
    paths = {"vocab": os.path.join(root, "vocab.txt"),
             "features": os.path.join(root, "features", "predictions.tsv"),
             "captions": os.path.join(root, "captions.json"),
             "id2phrase": os.path.join(root, "id2phrase.json")}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(specials + words) + "\n")
    phrases = [[words[int(a)], words[int(b)]]
               for a, b in rng.integers(0, len(words), (CLI_PHRASES, 2))]
    with open(paths["id2phrase"], "w") as f:
        json.dump({str(CLI_VOCAB + i): p for i, p in enumerate(phrases)}, f)
    keys = [f"img_{i:05d}" for i in range(n_images or CLI_IMAGES)]
    tag_words = words[:2000]
    tags = {k: [tag_words[int(t)] for t in rng.integers(0, 2000, CLI_TAGS)]
            for k in keys}
    nbytes, boxes = [0], {}

    def rows():
        for k in keys:
            feats = rng.standard_normal((CLI_REGIONS, 2054), np.float32)
            if finetune:
                xy = rng.uniform(0.0, 0.5, (CLI_REGIONS, 2))
                wh = rng.uniform(0.05, 0.5, (CLI_REGIONS, 2))
                feats[:, -6:] = np.concatenate([xy, xy + wh, wh], 1)
                boxes[k] = feats[:, -6:-2].copy()
            nbytes[0] += feats.nbytes
            yield [k, json.dumps({
                "feature": base64.b64encode(feats.tobytes()).decode(),
                "predictions": tags[k]})]
    tsv_writer(rows(), paths["features"])
    with open(os.path.join(root, "features", "imageid2idx.json"), "w") as f:
        json.dump({k: i for i, k in enumerate(keys)}, f)
    caps = {}
    for k in keys:
        caps[k] = []
        for _ in range(CLI_CAPS):
            filler = rng.integers(0, len(words), CLI_WORDS_PER_CAP - 5)
            caps[k].append({
                "text": " ".join(tags[k][:5] + [words[int(w)] for w in filler]),
                "phrases": [phrases[int(j)]
                            for j in rng.integers(0, CLI_PHRASES, 8)]})
    with open(paths["captions"], "w") as f:
        json.dump(caps, f)
    if corpus:
        paths["corpus"] = os.path.join(root, "corpus.tsv")
        paths["tag2id"] = os.path.join(root, "tag2id.json")
        rows = []
        for k in keys:
            for j in range(CLI_CAPS):
                filler = rng.integers(0, len(words), CLI_WORDS_PER_CAP - 5)
                answer = (tags[k][int(rng.integers(0, CLI_TAGS))]
                          if len(rows) % 2 else "")
                rows.append([
                    k, " ".join(tags[k][:5] + [words[int(w)] for w in filler]),
                    json.dumps([phrases[int(p)] for p in
                                rng.integers(0, CLI_PHRASES, 8)]),
                    int(rng.integers(0, QA_ANSWERS)), answer])
        tsv_writer(rows, paths["corpus"])
        with open(paths["tag2id"], "w") as f:
            json.dump({t: i for i, t in enumerate(tag_words)}, f)
    if finetune:
        paths.update(write_finetune_files(root, rng, words, phrases, tags,
                                          boxes))
    if nlvr:
        paths.update(write_nlvr_files(root, rng, words, tags))
    return paths, nbytes[0], os.path.getsize(paths["features"])


@contextlib.contextmanager
def around_steps(before=None, after=None):
    """`before(trainer)` and `after(trainer, metrics)` around every
    `Trainer.step` inside (nested: the inner one runs inside the outer)."""
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    real = Trainer.step

    def step(self, batch):
        if before is not None:
            before(self)
        out = real(self, batch)
        if after is not None:
            after(self, out)
        return out
    Trainer.step = step
    try:
        yield
    finally:
        Trainer.step = real


@contextlib.contextmanager
def counted_steps(attn, per_step, what):
    """Every `Trainer.step` inside must launch the dropout kernel exactly
    `per_step` times and the plain attention never; yields the running
    launch total."""
    total = [0]

    def after(trainer, metrics):
        check_counts(attn, per_step, what)
        total[0] += attn.masked_attention.launches
    with around_steps(lambda trainer: reset_counts(attn), after):
        yield total


def mean(xs):
    return sum(xs) / len(xs)


def phase7_cli(torch, attn, sweep_pairs_per_s=None):
    """The retrieval command line (`tasks.retrieval.main`) at MVPTR-base on a
    generated root: in-memory baseline, CLI training through the process
    loader, CLI eval against `two_stage_scoring` in memory."""
    import gc
    import shutil
    from mvp_pytorch_tpu_torch import native
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore,
                                                     RetrievalDataset,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import RetrievalModel
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase7")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root)
        log(f"  root: {CLI_IMAGES} images x {CLI_CAPS} captions, "
            f"{CLI_REGIONS} regions x 2054 fp32 ({feat_bytes / 1e6:.1f} MB of "
            f"features, {tsv_bytes / 1e6:.1f} MB of TSV) written in "
            f"{time.perf_counter() - t0:.1f} s")
        data = ["--captions_json", paths["captions"],
                "--feature_tsv", paths["features"],
                "--id2phrase", paths["id2phrase"]]
        args = ret.get_args(["--output_dir", root] + data + CLI_ARGS
                            + CLI_PLATFORM)
        tokenizer = FastBertTokenizer(paths["vocab"])
        log(f"  native tokenizer and feature decode: {native.available()} "
            f"(tokenizer native_active={tokenizer.native_active})")

        dataset = RetrievalDataset(
            paths["captions"], FeatureStore(paths["features"]), tokenizer,
            sg2id=load_phrase_vocab(paths["id2phrase"]),
            cfg=tensorize_cfg(args))
        fetch = ret.RetrievalFetch(dataset, use_phrase=False)
        sampler = BatchSampler(len(dataset), TRAIN_B, seed=args.seed)

        # 2. in-memory baseline: the same batches, fetched first
        t0 = time.perf_counter()
        batches = [fetch(sampler.batch_at(s)) for s in range(CLI_MEM_STEPS)]
        fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
        shapes = {k: v.shape for k, v in batches[0].items()}
        log(f"  a batch fetched on the main thread: {fetch_ms:.1f} ms; "
            f"shapes {shapes}")
        if (shapes["input_ids_a"] != (TRAIN_B, 75)
                or shapes["attention_mask_b"] != (TRAIN_B, 70)
                or shapes["img_feats"] != (TRAIN_B, CLI_REGIONS, 2054)):
            raise AssertionError(f"batch shapes {shapes}")
        cfg = build_config(args, tokenizer, num_labels=2)
        per_step = cfg.half_layers * 4
        model = RetrievalModel(cfg, device=DEVICE, seed=args.seed)
        with counted_steps(attn, per_step, "an in-memory step") as total:
            torch.cuda.reset_peak_memory_stats()
            mem = ret.train_retrieval(
                model, batches, CLI_MEM_STEPS, learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, seed=args.seed,
                max_tag_length=args.max_tag_length, hn_mod="hard")
        mem_peak = torch.cuda.max_memory_allocated() / 1e9
        mem_first = mem[0]["loss"]
        mem_ms = mean([m["step_ms"] for m in mem[CLI_MEM_TIMED_FROM - 1:]])
        mem_sps = TRAIN_B / mem_ms * 1e3
        log(f"  in memory: {CLI_MEM_STEPS} steps, {total[0]} launches; steps "
            f"{CLI_MEM_TIMED_FROM}-{CLI_MEM_STEPS}: {mem_ms:.2f} ms/step "
            f"{mem_sps:.1f} samples/s, peak {mem_peak:.2f} GB; losses "
            + " ".join(f"{m['loss']:.4f}" for m in mem))
        del model, batches, mem
        gc.collect()
        torch.cuda.empty_cache()

        # 3. training through the CLI and the process loader
        out = os.path.join(root, "cli_train")
        argv = (["--output_dir", out, "--do_train", "--max_steps",
                 str(CLI_STEPS), "--train_batch_size", str(TRAIN_B),
                 "--log_period", "1", "--ckpt_period", str(CLI_STEPS),
                 "--num_workers", "4", "--worker_start_method", "fork",
                 "--data_dir", root] + data + CLI_ARGS + CLI_PLATFORM)
        log("  python -m mvp_pytorch_tpu_torch.tasks.retrieval "
            + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                       for a in argv))
        with counted_steps(attn, per_step, "a CLI training step") as total:
            torch.cuda.reset_peak_memory_stats()
            hist = ret.main(argv)["train"]
        cli_peak = torch.cuda.max_memory_allocated() / 1e9
        cli_launches = total[0]
        losses = [m["loss"] for m in hist]
        timed = hist[CLI_TIMED_FROM - 1:]
        cli_ms = mean([m["step_ms"] for m in timed])
        cli_sps = TRAIN_B / cli_ms * 1e3
        data_ms = mean([m["data_ms"] for m in timed])
        worker_ms = mean([m["worker_ms"] for m in timed])
        h2d_ms = mean([m.get("h2d_ms", float("nan")) for m in timed])
        # from seeded weights every caption and image starts with the same
        # [CLS], whose symmetry 26 steps do not break on real-format data:
        # the losses fall from their start to chance, ln B + ln 2, and stay
        # there (phase 5's batch, random ids at every position, learns)
        chance = math.log(TRAIN_B) + math.log(2)
        log("  CLI losses " + " ".join(f"{x:.4f}" for x in losses)
            + f" (chance {chance:.4f})")
        if (len(hist) != CLI_STEPS or not all(map(math.isfinite, losses))
                or mean(losses[-5:]) >= losses[0]):
            raise AssertionError(f"CLI training losses not finite and "
                                 f"falling: {losses}")
        # step 1 is the in-memory run's step 1 (same weights, batch, dropout
        # draws and learning rate): the loader delivered that batch intact
        log(f"  step 1 loss: CLI {losses[0]:.6f}, in memory {mem_first:.6f}")
        if abs(losses[0] - mem_first) > STEP_TOL["bfloat16"][0]:
            raise AssertionError("the CLI's first batch is not the sampler's")
        ratio = cli_sps / mem_sps
        log(f"  CLI: {CLI_STEPS} steps, {cli_launches} launches (24 a step, "
            f"all with dropout, plain 0); steps {CLI_TIMED_FROM}-{CLI_STEPS}: "
            f"{cli_ms:.2f} ms/step {cli_sps:.1f} samples/s, peak "
            f"{cli_peak:.2f} GB; main thread data {data_ms:.3f} ms/step, "
            f"worker {worker_ms:.1f} ms/batch, H2D {h2d_ms:.3f} ms/batch")
        log(f"  CLI samples/s / in-memory samples/s = {cli_sps:.1f} / "
            f"{mem_sps:.1f} = {ratio:.3f} (target 0.90)")
        gc.collect()
        torch.cuda.empty_cache()

        # 4. eval through the CLI from the trained checkpoint
        ckpt = os.path.join(out, f"checkpoint-{CLI_STEPS:07d}")
        shutil.copy(paths["vocab"], ckpt)
        argv = (["--output_dir", os.path.join(root, "cli_eval"),
                 "--model_name_or_path", ckpt, "--do_eval", "--dtype",
                 "bfloat16"] + data + CLI_EVAL_ARGS + CLI_PLATFORM)
        reset_counts(attn)
        res = ret.main(argv)["eval"]
        torch.cuda.synchronize()
        got = (attn.masked_attention.launches,
               attn.masked_attention.dropout_launches,
               attn.plain_attention.calls)
        sec = res["seconds"]
        sweep = sum(sec[s] for s in ("encode_text", "encode_image", "coarse",
                                     "rerank"))
        pairs_per_s = res["n_pairs"] / sweep
        log(f"  CLI eval: {got[0]} launches ({got[1]} with dropout, plain "
            f"{got[2]}), pairs={res['n_pairs']}  "
            + "  ".join(f"{k}={v:.4f}s" for k, v in sec.items())
            + f"  pairs/s={pairs_per_s:.1f}"
            + (f" (phase 3 bf16 sweep: {sweep_pairs_per_s:.1f})"
               if sweep_pairs_per_s else ""))
        log(f"    coarse {json.dumps(res['coarse'])}")
        log(f"    fine   {json.dumps(res['fine'])}")
        ek = dict(zip(CLI_EVAL_ARGS[::2], map(int, CLI_EVAL_ARGS[1::2])))
        n_cap = CLI_IMAGES * CLI_CAPS
        want = cfg.half_layers * (
            math.ceil(n_cap / ek["--eval_batch_size"])
            + math.ceil(CLI_IMAGES / ek["--eval_batch_size"])
            + math.ceil(res["n_pairs"] / ek["--rerank_batch_size"]))
        if got != (want, 0, 0) or (DEVICE == "cuda" and want != 492):
            raise AssertionError(f"CLI eval launched {got}, want "
                                 f"({want} = 492, 0, 0)")
        model = load_checkpoint(torch, RetrievalModel, ckpt)
        ref = ret.two_stage_scoring(
            model, ret.port_names(dataset.caption_arrays()),
            ret.port_names(dataset.image_arrays()), CLI_CAPS,
            ek["--num_captions_per_img_val"], ek["--num_images_per_cap_val"],
            ek["--eval_batch_size"], ek["--rerank_batch_size"],
            max_tag_length=args.max_tag_length)
        score_err = float(np.abs(ref["scores"] - res["scores"]).max())
        same = (ref["coarse"] == res["coarse"] and ref["fine"] == res["fine"]
                and np.array_equal(ref["i2t_cands"], res["i2t_cands"])
                and np.array_equal(ref["t2i_cands"], res["t2i_cands"]))
        log(f"  CLI eval against two_stage_scoring in memory: ranks and "
            f"candidates {'equal' if same else 'DIFFER'}, max|score diff| "
            f"{score_err:.3e} (tol {SCORE_TOL:g})")
        if not same or score_err > SCORE_TOL:
            raise AssertionError("CLI eval differs from two_stage_scoring")
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 7 took {seconds:.1f} s")
    return dict(native=native.available(), launches=cli_launches,
                launches_per_step=per_step, eval_launches=got[0],
                samples_per_s=cli_sps, step_ms=cli_ms, peak_gb=cli_peak,
                in_memory_samples_per_s=mem_sps, in_memory_step_ms=mem_ms,
                ratio=ratio, main_data_ms=data_ms, worker_ms=worker_ms,
                h2d_ms=h2d_ms, main_fetch_ms=fetch_ms,
                eval_pairs_per_s=pairs_per_s, eval_score_err=score_err,
                losses=losses, seconds=seconds)


# phase 8: the pretraining command line on a generated corpus at the real
# widths (phase 7's root plus a corpus.tsv and a tag2id.json)
PRE_ARGS = ["--max_seq_length", "70", "--max_phrases", "5",   # LA 75
            "--max_tag_length", "20", "--max_img_seq_length", "50",
            "--dtype", "bfloat16", "--seed", "11",
            "--hidden_dropout_prob", str(DROP_P),
            "--attention_dropout_prob", str(DROP_P), "--learning_rate", "1e-4"]
PRE_QA_STEPS = 3
MASK_SHARE, MASK_SHARE_TOL = 0.15, 0.02     # --mask_prob's default


def mask_shares(batch, max_tag_length):
    """The masked share of the real text tokens (labelled positions over the
    tokens before the phrase span) and of the regions (rows whose features
    masking zeroed, geometry kept); also whether the region labels sit
    exactly on the zeroed rows."""
    lab_a = np.asarray(batch["lm_label_ids_a"])
    text = int((np.asarray(batch["phrase_index"])[:, 0] - 1).sum())
    zeroed = (np.asarray(batch["img_feats"])[:, :, :-6] == 0).all(-1)
    region_labels = np.asarray(batch["lm_label_ids_b"])[:, max_tag_length:] >= 0
    return (float((lab_a >= 0).sum()) / text, float(zeroed.mean()),
            bool(np.array_equal(zeroed, region_labels)))


def phase8_pretrain_cli(torch, attn, layers_mod):
    """The pretraining command line (`tasks.pretrain.main`) at MVPTR-base on
    a generated corpus: the masks made in the workers, an in-memory
    baseline, one kernel-vs-plain step on the first real batch, CLI training
    through the process loader, and a short QA run."""
    import dataclasses
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler, ProcessLoader
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.tasks.common import build_config
    from mvp_pytorch_tpu_torch.training.loop import batch_on
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase8")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, corpus=True)
        n_rows = CLI_IMAGES * CLI_CAPS
        log(f"  root: {CLI_IMAGES} images, {n_rows} corpus rows (every other "
            f"a QA pair), {CLI_REGIONS} regions x 2054 fp32 "
            f"({feat_bytes / 1e6:.1f} MB of features, {tsv_bytes / 1e6:.1f} "
            f"MB of TSV) written in {time.perf_counter() - t0:.1f} s")
        data = ["--corpus_tsv", paths["corpus"],
                "--feature_tsv", paths["features"],
                "--id2phrase", paths["id2phrase"], "--tag2id", paths["tag2id"]]
        args = pre.get_args(["--output_dir", root] + data + PRE_ARGS
                            + CLI_PLATFORM)
        tokenizer = FastBertTokenizer(paths["vocab"])
        cfg = build_config(args, tokenizer, qa_answer_size=0)
        dataset = pre.build_dataset(args, tokenizer, cfg)
        fetch = pre.PretrainFetch(dataset)
        sampler = BatchSampler(len(dataset), TRAIN_B, seed=args.seed)
        step_kw = dict(max_tag_length=args.max_tag_length,
                       hn_mod=args.hn_mod, phrase_mod=args.phrase_mod,
                       max_pred_a=args.max_pred_a, max_pred_b=args.max_pred_b)

        # 1. the masks: the shares in the first batch; epochs differ, and the
        # loader's worker masks a step of epoch 1 as epoch 1
        t0 = time.perf_counter()
        batches = [fetch(sampler.batch_at(s), sampler.epoch_at(s))
                   for s in range(CLI_MEM_STEPS)]
        fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
        shapes = {k: v.shape for k, v in batches[0].items()}
        log(f"  a batch fetched and masked on the main thread: "
            f"{fetch_ms:.1f} ms; shapes {shapes}")
        la = args.max_seq_length + args.max_phrases
        if (shapes["input_ids_a"] != (TRAIN_B, la)
                or shapes["lm_label_ids_b"] != (TRAIN_B, 70)
                or shapes["img_feats"] != (TRAIN_B, CLI_REGIONS, 2054)
                or {"is_next", "is_img_match", "qa_ans"} & set(shapes)):
            raise AssertionError(f"batch shapes {shapes}")
        text_share, region_share, labels_on_regions = mask_shares(
            batches[0], args.max_tag_length)
        log(f"  first batch: masked share of text tokens {text_share:.4f}, "
            f"of regions {region_share:.4f} (want {MASK_SHARE} +- "
            f"{MASK_SHARE_TOL}); tag labels on exactly the masked regions: "
            f"{labels_on_regions}")
        if (abs(text_share - MASK_SHARE) > MASK_SHARE_TOL
                or abs(region_share - MASK_SHARE) > MASK_SHARE_TOL
                or not labels_on_regions):
            raise AssertionError("the first batch's masks are off")
        spe = sampler.epoch_len // TRAIN_B
        idx = sampler.batch_at(spe)
        loader = ProcessLoader(fetch, sampler, start_step=spe, num_workers=1,
                               device=DEVICE, multiprocessing_context="fork")
        for step, got in loader:
            got = {k: v.cpu().numpy() for k, v in got.items()}
            break
        loader.close()
        want1, want0 = fetch(idx, 1), fetch(idx, 0)
        same1 = all(np.array_equal(got[k], want1[k]) for k in want1)
        differ0 = not np.array_equal(got["lm_label_ids_a"],
                                     want0["lm_label_ids_a"])
        log(f"  loader at step {step} (epoch {sampler.epoch_at(step)}): "
            f"equal to fetch(indices, 1): {same1}; text masks differ from "
            f"epoch 0's on the same rows: {differ0}")
        if step != spe or sampler.epoch_at(step) != 1 or not (same1 and differ0):
            raise AssertionError("the loader did not mask by epoch")
        del loader, got, want0, want1

        # 2. in-memory baseline on the same batches
        per_step = cfg.half_layers * 4
        model = BiPretrainModel(cfg, device=DEVICE, seed=args.seed)
        with counted_steps(attn, per_step, "an in-memory step") as total:
            torch.cuda.reset_peak_memory_stats()
            mem = pre.train_pretrain(
                model, batches, CLI_MEM_STEPS, learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, seed=args.seed, **step_kw)
        mem_peak = torch.cuda.max_memory_allocated() / 1e9
        mem_first = mem[0]["loss"]
        mem_ms = mean([m["step_ms"] for m in mem[CLI_MEM_TIMED_FROM - 1:]])
        mem_sps = TRAIN_B / mem_ms * 1e3
        log(f"  in memory: {CLI_MEM_STEPS} steps, {total[0]} launches; steps "
            f"{CLI_MEM_TIMED_FROM}-{CLI_MEM_STEPS}: {mem_ms:.2f} ms/step "
            f"{mem_sps:.1f} samples/s, peak {mem_peak:.2f} GB; losses "
            + " ".join(f"{m['loss']:.4f}" for m in mem))
        del model, mem
        gc.collect()
        torch.cuda.empty_cache()

        # 3. one step at dropouts 0 on the first real batch, kernel path
        # against plain path, the draws and the hard pairs pinned: in fp32
        # every loss and gradient is held; in bf16 the losses are held and
        # the gradients printed beside each path's distance from the fp32
        # gradient (on real masks both bf16 paths sit about 0.06 from it, so
        # their gap is bf16 rounding, not the kernel)
        batch = batch_on(DEVICE, batches[0])
        dice = torch.randperm(TRAIN_B, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(9))
        ref = None
        for dn in ("float32", "bfloat16"):
            cfg0 = dataclasses.replace(cfg, dtype=dn, hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
            model = BiPretrainModel(cfg0, device=DEVICE, seed=args.seed)
            model.train()

            def step():
                model.zero_grad(set_to_none=True)
                out = model.train_step(
                    *(batch.get(k) for k in pre.PRETRAIN_KEYS), hn_dice=dice,
                    wra_pick=1, wra_neg_offset=1,
                    generator=torch.Generator(device=DEVICE).manual_seed(0),
                    **step_kw)
                out.total_loss.backward()
                params = dict(model.named_parameters())
                return out, {n: params[n].grad.detach().float().clone()
                             for n in PRETRAIN_GRAD_PARAMS}

            reset_counts(attn)
            with hard_pairs(model) as mined:
                k_out, k_grads = step()
            torch.cuda.synchronize()
            if (attn.masked_attention.launches != per_step
                    or attn.masked_attention.dropout_launches != 0):
                raise AssertionError("kernel path did not launch the p = 0 "
                                     "kernel")
            with plain_attention_path(layers_mod, attn), hard_pairs(
                    model, pinned=mined[0]):
                p_out, p_grads = step()
            torch.cuda.synchronize()
            if attn.masked_attention.launches != per_step:
                raise AssertionError("plain path launched the kernel")
            losses_held = [n for n in PRETRAIN_LOSSES if n != "qa_loss"]
            if ref is None:
                compare_step(torch, "real batch", dn, k_out, p_out,
                             losses_held, k_grads, p_grads)
                ref = p_grads
            else:
                compare_step(torch, "real batch", dn, k_out, p_out,
                             losses_held, {}, {})
                def rel(a, b):
                    return ((a - b).norm() / b.norm()).item()
                for n in PRETRAIN_GRAD_PARAMS:
                    log(f"  real batch {dn:9s} grad {n}: kernel vs plain "
                        f"{rel(k_grads[n], p_grads[n]):.3e}; from the fp32 "
                        f"gradient: kernel {rel(k_grads[n], ref[n]):.3e}, "
                        f"plain {rel(p_grads[n], ref[n]):.3e} (printed)")
            del model, k_out, p_out, k_grads, p_grads
            gc.collect()
            torch.cuda.empty_cache()
        del batch, batches, ref
        gc.collect()
        torch.cuda.empty_cache()

        # 4. training through the CLI and the process loader
        out = os.path.join(root, "cli_train")
        common = ["--train_batch_size", str(TRAIN_B), "--log_period", "1",
                  "--num_workers", "4", "--worker_start_method", "fork",
                  "--data_dir", root] + data + PRE_ARGS + CLI_PLATFORM
        argv = (["--output_dir", out, "--max_steps", str(CLI_STEPS),
                 "--ckpt_period", str(CLI_STEPS)] + common)
        log("  python -m mvp_pytorch_tpu_torch.tasks.pretrain "
            + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                       for a in argv))
        with counted_steps(attn, per_step, "a CLI pretraining step") as total:
            torch.cuda.reset_peak_memory_stats()
            hist = pre.main(argv)["train"]
        cli_peak = torch.cuda.max_memory_allocated() / 1e9
        cli_launches = total[0]
        losses = [m["loss"] for m in hist]
        timed = hist[CLI_TIMED_FROM - 1:]
        cli_ms = mean([m["step_ms"] for m in timed])
        cli_sps = TRAIN_B / cli_ms * 1e3
        data_ms = mean([m["data_ms"] for m in timed])
        worker_ms = mean([m["worker_ms"] for m in timed])
        h2d_ms = mean([m.get("h2d_ms", float("nan")) for m in timed])
        log("  CLI losses " + " ".join(f"{x:.4f}" for x in losses))
        names = ("vis_mlm", "clip", "mlm", "itm", "wra")
        for when, m in (("first", hist[0]), ("last", hist[-1])):
            log(f"  {when} step: " + " ".join(f"{k}={m[k]:.4f}"
                                              for k in names))
        if (len(hist) != CLI_STEPS or not all(map(math.isfinite, losses))
                or mean(losses[-5:]) >= losses[0]):
            raise AssertionError(f"CLI pretraining losses not finite and "
                                 f"falling: {losses}")
        log(f"  step 1 loss: CLI {losses[0]:.6f}, in memory {mem_first:.6f}")
        if abs(losses[0] - mem_first) > STEP_TOL["bfloat16"][0]:
            raise AssertionError("the CLI's first batch is not the sampler's")
        ratio = cli_sps / mem_sps
        log(f"  CLI: {CLI_STEPS} steps, {cli_launches} launches (24 a step, "
            f"all with dropout, plain 0); steps {CLI_TIMED_FROM}-{CLI_STEPS}: "
            f"{cli_ms:.2f} ms/step {cli_sps:.1f} samples/s, peak "
            f"{cli_peak:.2f} GB; main thread data {data_ms:.3f} ms/step, "
            f"worker {worker_ms:.1f} ms/batch, H2D {h2d_ms:.3f} ms/batch")
        log(f"  CLI samples/s / in-memory samples/s = {cli_sps:.1f} / "
            f"{mem_sps:.1f} = {ratio:.3f} (target 0.90)")
        gc.collect()
        torch.cuda.empty_cache()

        # 5. the QA heads through the CLI: a few steps
        argv = (["--output_dir", os.path.join(root, "cli_qa"), "--max_steps",
                 str(PRE_QA_STEPS), "--ckpt_period", "0", "--use_qa",
                 "--qa_answer_size", str(QA_ANSWERS), "--use_qa_pairs"]
                + common)
        with counted_steps(attn, per_step, "a CLI QA step") as qa_total:
            qa_hist = pre.main(argv)["train"]
        qa = [m.get("qa", float("nan")) for m in qa_hist]
        log(f"  CLI with --use_qa --use_qa_pairs: {len(qa_hist)} steps, "
            f"{qa_total[0]} launches; qa losses "
            + " ".join(f"{x:.4f}" for x in qa))
        if len(qa_hist) != PRE_QA_STEPS or not all(map(math.isfinite, qa)):
            raise AssertionError(f"the QA run's qa losses: {qa}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8 took {seconds:.1f} s")
    return dict(launches=cli_launches, launches_per_step=per_step,
                qa_launches=qa_total[0], samples_per_s=cli_sps,
                step_ms=cli_ms, peak_gb=cli_peak,
                in_memory_samples_per_s=mem_sps, in_memory_step_ms=mem_ms,
                in_memory_peak_gb=mem_peak, ratio=ratio, main_data_ms=data_ms,
                worker_ms=worker_ms, h2d_ms=h2d_ms, main_fetch_ms=fetch_ms,
                text_mask_share=text_share, region_mask_share=region_share,
                first_step={k: hist[0][k] for k in ("loss",) + names},
                last_step={k: hist[-1][k] for k in ("loss",) + names},
                qa_losses=qa, seconds=seconds)


# phase 9: VQA, SNLI-VE and referring-expression fine-tuning through their
# command lines on phase 7's features with task files at the real widths
FT_QUESTIONS, FT_EVAL, FT_VE_PAIRS, FT_MAX_DET = 2000, 1000, 3000, 20
FT_B = {"vqa": 32, "ve": 64, "re": 32}
FT_LR = {"vqa": "5e-5", "ve": "4e-5", "re": "4e-5"}
FT_STEPS, FT_SHORT = 13, 3                  # VE / RE CLI steps; short runs
FT_ARGS = ["--max_seq_length", "35", "--max_phrases", "5",   # LA 40
           "--max_tag_length", "20", "--max_img_seq_length", "50",
           "--dtype", "bfloat16", "--seed", "11",
           "--hidden_dropout_prob", str(DROP_P),
           "--attention_dropout_prob", str(DROP_P)]
FT_EVAL_B = 64
# the VQA real batch in bf16, kernel path against plain path: the logits
# leave the QA decoder in bf16, so their gap is held in bf16 ulps at the
# batch's largest |logit|; the loss sums the BCE of 3,129 answers (about
# 2,300 at init), so its gap is held relative to the loss
FT_BF16_LOGIT_ULPS, FT_BF16_LOSS_REL = 4, 1e-4
FT_GRAD_PARAMS = ("cls.predictions.decoder.weight",
                  "cls.predictions.transform.dense.weight",
                  "bert.txt_encoder.layer.0.attention.self.query.weight",
                  "bert.vis_encoder.layer.0.attention.self.query.weight",
                  "bert.mul_encoder.layer.0.attention.self.query.weight")
# attention shapes of the fine-tuning steps: (name, B, L)
FT_SHAPES = tuple((name, b, l, "bfloat16", (DROP_P, 0.0), "key")
                  for name, b, l in (("fused", 64, 90), ("fused", 32, 90),
                                     ("text", 64, 40), ("text", 32, 40)))


def write_finetune_files(root, rng, words, phrases, tags, boxes):
    """The task files over `write_cli_root`'s images, by the learnable rules
    of the port's `data/synthetic.py`: FT_QUESTIONS VQA questions whose
    answer (of QA_ANSWERS) is set by the image's first tag, each with up to
    10 soft scores (`vqa.jsonl`; the first FT_EVAL in `vqa_val.jsonl`) and
    `label2ans.json`; FT_VE_PAIRS SNLI-VE hypotheses, entailment naming one
    of the image's tags, contradiction a tag word it lacks, neutral a word
    that is no tag (`ve.jsonl`; the first FT_EVAL in `ve_val.jsonl`); one
    expression an image whose gt box is its largest region's (`re.json`),
    and up to FT_MAX_DET detections an image, one of them near the gt box
    (`re_dets.json`)."""
    keys = sorted(tags)
    tag_words = words[:2000]
    tag_index = {t: i for i, t in enumerate(tag_words)}
    plain_words = words[2000:]

    def text(n):
        return " ".join(plain_words[int(w)]
                        for w in rng.integers(0, len(plain_words), n))

    def some_phrases():
        return [phrases[int(j)] for j in rng.integers(0, len(phrases), 4)]

    out = {k: os.path.join(root, f) for k, f in (
        ("vqa", "vqa.jsonl"), ("vqa_val", "vqa_val.jsonl"),
        ("label2ans", "label2ans.json"), ("ve", "ve.jsonl"),
        ("ve_val", "ve_val.jsonl"), ("re", "re.json"),
        ("re_dets", "re_dets.json"))}
    lines = []
    for q in range(FT_QUESTIONS):
        k = keys[q % len(keys)]
        ans = [tag_index[tags[k][0]] % QA_ANSWERS]
        for a in rng.integers(0, QA_ANSWERS, int(rng.integers(0, 10))):
            if int(a) not in ans:
                ans.append(int(a))
        scores = [1.0] + [float(s) for s in rng.choice([0.3, 0.6, 0.9],
                                                         len(ans) - 1)]
        lines.append(json.dumps({"question_id": q, "image_id": k,
                                 "question": text(12), "labels": ans,
                                 "scores": scores,
                                 "phrases": some_phrases()}))
    for name, n in (("vqa", FT_QUESTIONS), ("vqa_val", FT_EVAL)):
        with open(out[name], "w") as f:
            f.write("\n".join(lines[:n]) + "\n")
    with open(out["label2ans"], "w") as f:
        json.dump([f"answer_{i}" for i in range(QA_ANSWERS)], f)
    lines = []
    labels = ("contradiction", "neutral", "entailment")
    for i in range(FT_VE_PAIRS):
        k, lab = keys[i % len(keys)], labels[i % 3]
        if lab == "entailment":
            word = tags[k][int(rng.integers(0, len(tags[k])))]
        elif lab == "contradiction":
            absent = sorted(set(tag_words) - set(tags[k]))
            word = absent[int(rng.integers(0, len(absent)))]
        else:
            word = text(1)
        lines.append(json.dumps({
            "pairID": f"p{i}", "Flickr30K_ID": k,
            "sentence2": f"{text(3)} {word} {text(2)}", "gold_label": lab,
            "phrases": some_phrases()}))
    for name, n in (("ve", FT_VE_PAIRS), ("ve_val", FT_EVAL)):
        with open(out[name], "w") as f:
            f.write("\n".join(lines[:n]) + "\n")
    items, dets = [], {}
    expression = text(6)
    for k in keys:
        b = boxes[k]
        gt = b[int(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).argmax())]
        items.append({"image_id": k, "expression": expression,
                      "gt_box": [float(v) for v in gt],
                      "phrases": some_phrases()})
        w, h = gt[2] - gt[0], gt[3] - gt[1]
        near = [gt[0] + 0.05 * w, gt[1] + 0.05 * h, gt[2] - 0.05 * w,
                gt[3] - 0.05 * h]
        n = int(rng.integers(4, FT_MAX_DET + 1))
        xy = rng.uniform(0.0, 0.5, (n - 1, 2))
        wh = rng.uniform(0.05, 0.5, (n - 1, 2))
        boxes_k = np.concatenate([xy, xy + wh], 1).tolist()
        boxes_k.insert(int(rng.integers(0, n)), [float(v) for v in near])
        dets[k] = boxes_k
    with open(out["re"], "w") as f:
        json.dump(items, f)
    with open(out["re_dets"], "w") as f:
        json.dump(dets, f)
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def padded_forward(model, arrays, batch_size, input_names=None, **kw):
    """The drivers' padded eval (`tasks.common.predict`) over a dataset's
    arrays fetched at once, not chunk by chunk as the drivers fetch them;
    fp32 numpy. `input_names`: the data plane's names of the model's inputs
    (the single pair's seven by default)."""
    from mvp_pytorch_tpu_torch.tasks.common import INPUT_NAMES, predict
    names = input_names or INPUT_NAMES

    class InMemory:
        def __len__(self):
            return len(arrays["input_ids_a"])

        def fetch(self, idx):
            return {k: arrays[k][idx] for k in names}
    return predict(model, InMemory(), batch_size,
                   lambda m, *x: m(*x, **kw), input_names=names)[0]


def attention_times(torch, attn, shapes, seed):
    """The kernel at a path's attention shapes (blhd): `shapes` holds (name,
    B, L, dtype, dropout rates, key mask: "nlvr" for `nlvr_key_mask`,
    "single" for `single_stream_key_mask`, else random padded lengths). At
    each rate: the max abs error against the plain version on the same
    inputs and seed, the kernel's ms, the plain version's ms, SDPA's ms with
    the same mask and dropout, and the bound.
    Rows are keyed "{name} B {b} L {l} p {p}", with " fp32" for fp32."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    out = {}
    for name, b, l, dn, rates, mask_kind in shapes:
        dt = dtypes[dn]
        q, k, v = (torch.randn(b, l, H, D, device=DEVICE, generator=gen)
                   .to(dt) for _ in range(3))
        if mask_kind == "nlvr":
            mask = nlvr_key_mask(torch, gen, b)
        elif mask_kind == "single":
            mask = single_stream_key_mask(torch, gen, b)
        else:
            lens = torch.randint(l // 2, l + 1, (b,), device=DEVICE,
                                 generator=gen)
            mask = (torch.arange(l, device=DEVICE)[None, :]
                    < lens[:, None]).to(torch.int32)
        bias = attn.mask_to_bias(mask)
        seed_t = torch.randint(-2 ** 63, 2 ** 63 - 1, (1,),
                               dtype=torch.int64, device=DEVICE,
                               generator=gen)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        bound, by = attention_bound_ms(b, l, l, dn, bias)
        for p in rates:
            s = seed_t if p else None
            got = attn.masked_attention(q, k, v, bias, layout="blhd",
                                        dropout_p=p, seed=s)
            want = attn.plain_attention_blhd(q, k, v, bias, p, s)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL[dn]:
                raise AssertionError(f"kernel vs plain {name} B {b} L {l} "
                                     f"{dn} p {p}: {err}")
            row = dict(
                max_abs_err=err, bound_ms=bound, bound_by=by,
                ms=cuda_ms(lambda: attn.masked_attention(
                    q, k, v, bias, layout="blhd", dropout_p=p, seed=s)),
                plain_ms=cuda_ms(lambda: attn.plain_attention_blhd(
                    q, k, v, bias, p, s), iters=5),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=bias.to(dt), dropout_p=p)))
            key = f"{name} B {b} L {l} p {p:g}" + (
                " fp32" if dn == "float32" else "")
            out[key] = row
            log(f"  kernel {name:5s} B={b} L={l} {dn} p={p:g}: max|err| "
                f"{err:.3e}  kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  sdpa {row['sdpa_ms']:.4f} ms  "
                f"bound {bound:.4f} ms ({by})")
        del q, k, v, qh, kh, vh, bias, got, want
    torch.cuda.synchronize()
    return out


def cli_numbers(hist, b, peak, timed_from=CLI_TIMED_FROM):
    """step ms, samples/s, main-thread data ms and, through the loader,
    worker ms and H2D ms over the steps from `timed_from` on."""
    timed = hist[timed_from - 1:]
    ms = mean([m["step_ms"] for m in timed])
    out = dict(step_ms=ms, samples_per_s=b / ms * 1e3, peak_gb=peak,
               main_data_ms=mean([m["data_ms"] for m in timed]))
    for k in ("worker_ms", "h2d_ms"):
        if k in timed[0]:
            out[k] = mean([m[k] for m in timed])
    return out


def check_losses(hist, steps, what):
    losses = [m["loss"] for m in hist]
    log(f"  {what} losses " + " ".join(f"{x:.4f}" for x in losses))
    if len(hist) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return losses


def phase9_vqa(torch, attn, layers_mod, paths, root):
    """(a) VQA: kernel path against plain path on the first real batch,
    13 steps in memory, 26 through the CLI, the CLI's eval and test output
    against the model's forward in memory, and the kl -> bce and dropout
    schedules."""
    import dataclasses
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.datasets import VQADataset
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import VQAModel
    from mvp_pytorch_tpu_torch.models.layers import hidden_dropouts
    from mvp_pytorch_tpu_torch.tasks import vqa
    from mvp_pytorch_tpu_torch.tasks.common import (MODEL_KEYS, TaskFetch,
                                                    build_config,
                                                    tensorize_cfg)
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.training.loop import batch_on, train_on_batches
    b = FT_B["vqa"]
    data = ["--train_jsonl", paths["vqa"], "--feature_tsv", paths["features"],
            "--id2phrase", paths["id2phrase"], "--label2ans",
            paths["label2ans"], "--data_dir", root]
    common = (data + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["vqa"], "--train_batch_size", str(b),
                 "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    args = vqa.get_args(["--output_dir", root] + common)
    tokenizer = FastBertTokenizer(paths["vocab"])
    cfg = build_config(args, tokenizer, num_labels=QA_ANSWERS,
                       loss_type="bce")
    per_step = cfg.half_layers * 3           # text, vision, one fusion pass
    dataset = VQADataset(paths["vqa"], FeatureStore(paths["features"]),
                         tokenizer, QA_ANSWERS,
                         sg2id=load_phrase_vocab(paths["id2phrase"]),
                         cfg=tensorize_cfg(args))
    fetch = TaskFetch(dataset)
    sampler = BatchSampler(len(dataset), b, seed=args.seed)
    t0 = time.perf_counter()
    batches = [fetch(sampler.batch_at(s)) for s in range(CLI_MEM_STEPS)]
    fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
    shapes = {k: v.shape for k, v in batches[0].items()}
    log(f"  vqa: a batch fetched on the main thread: {fetch_ms:.1f} ms; "
        f"shapes {shapes}")
    if (shapes["input_ids_a"] != (b, 40) or shapes["attention_mask_b"]
            != (b, 70) or shapes["img_feats"] != (b, CLI_REGIONS, 2054)
            or shapes["label"] != (b, QA_ANSWERS)):
        raise AssertionError(f"vqa batch shapes {shapes}")

    # 1. the first real batch at dropout 0: kernel path against plain path
    batch = batch_on(DEVICE, batches[0])
    ref = None
    for dn in ("float32", "bfloat16"):
        model = VQAModel(dataclasses.replace(
            cfg, dtype=dn, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0), device=DEVICE, seed=args.seed)
        model.train()

        def step():
            model.zero_grad(set_to_none=True)
            loss, logits = model(*(batch[k] for k in MODEL_KEYS),
                                 labels=batch["label"], max_tag_length=20)
            loss.backward()
            params = dict(model.named_parameters())
            return ((loss.detach(), logits.detach()),
                    {n: params[n].grad.detach().float().clone()
                     for n in FT_GRAD_PARAMS})

        reset_counts(attn)
        (k_loss, k_logits), k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0):
            raise AssertionError("vqa kernel path did not launch the p = 0 "
                                 "kernel")
        with plain_attention_path(layers_mod, attn):
            (p_loss, p_logits), p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("vqa plain path launched the kernel")
        tol = E2E_TOL[dn]
        for name, a, c in (("logits", k_logits, p_logits),
                           ("loss", k_loss, p_loss)):
            gap = (a - c).abs().max().item()
            if ref is None:
                ok = bool(torch.isfinite(a).all()) and gap <= tol
                log(f"  vqa real batch {dn:9s} {name}: max|kernel-plain| "
                    f"{gap:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}")
            else:
                scale = c.abs().max().item()
                if name == "logits":
                    lim = FT_BF16_LOGIT_ULPS * bf16_ulp(scale)
                    rule = (f"{FT_BF16_LOGIT_ULPS} bf16 ulps at max|logit| "
                            f"{scale:.3f}")
                else:
                    lim = FT_BF16_LOSS_REL * scale
                    rule = f"{FT_BF16_LOSS_REL:g} of the loss {scale:.3f}"
                ok = bool(torch.isfinite(a).all()) and gap <= lim
                log(f"  vqa real batch {dn:9s} {name}: max|kernel-plain| "
                    f"{gap:.3e} tol {lim:.3e} ({rule}) "
                    f"{'ok' if ok else 'FAIL'}; from fp32 (printed): kernel "
                    f"{(a - ref[name]).abs().max().item():.3e}, plain "
                    f"{(c - ref[name]).abs().max().item():.3e}")
            if not ok:
                raise AssertionError(f"vqa real batch {dn} {name}")

        def rel(a, c):
            return ((a - c).norm() / c.norm()).item()
        for n in FT_GRAD_PARAMS:
            r = rel(k_grads[n], p_grads[n])
            if ref is None:
                ok = bool(torch.isfinite(k_grads[n]).all()) and r <= 1e-3
                log(f"  vqa real batch {dn:9s} grad {n}: rel err {r:.3e} "
                    f"tol 0.001 {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"vqa real batch {dn} grad {n}: {r}")
            else:
                log(f"  vqa real batch {dn:9s} grad {n}: kernel vs plain "
                    f"{r:.3e}; from the fp32 gradient: kernel "
                    f"{rel(k_grads[n], ref[n]):.3e}, plain "
                    f"{rel(p_grads[n], ref[n]):.3e} (printed)")
        ref = ref or dict(p_grads, logits=p_logits, loss=p_loss)
        del model, k_grads, p_grads, k_logits, p_logits
        gc.collect()
        torch.cuda.empty_cache()
    del batch, ref

    # 2. in memory: the same batches
    model = VQAModel(cfg, device=DEVICE, seed=args.seed)
    with counted_steps(attn, per_step, "a vqa in-memory step") as total:
        torch.cuda.reset_peak_memory_stats()
        mem = train_on_batches(model, vqa.vqa_loss_fn(args, cfg), batches,
                               CLI_MEM_STEPS, learning_rate=args.learning_rate,
                               weight_decay=args.weight_decay, seed=args.seed)
    mem_n = cli_numbers(mem, b, torch.cuda.max_memory_allocated() / 1e9,
                        CLI_MEM_TIMED_FROM)
    check_losses(mem, CLI_MEM_STEPS, "vqa in memory")
    log(f"  vqa in memory: {total[0]} launches; {mem_n['step_ms']:.2f} "
        f"ms/step {mem_n['samples_per_s']:.1f} samples/s, peak "
        f"{mem_n['peak_gb']:.2f} GB")
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the CLI and its process loader
    out = os.path.join(root, "vqa_train")
    argv = (["--output_dir", out, "--do_train", "--max_steps",
             str(CLI_STEPS), "--ckpt_period", str(CLI_STEPS)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.vqa " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    with counted_steps(attn, per_step, "a vqa CLI step") as total:
        torch.cuda.reset_peak_memory_stats()
        hist = vqa.main(argv)["train"]
    cli_n = cli_numbers(hist, b, torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(hist, CLI_STEPS, "vqa CLI")
    log(f"  vqa step 1 loss: CLI {losses[0]:.6f}, in memory "
        f"{mem[0]['loss']:.6f}")
    if abs(losses[0] - mem[0]["loss"]) > STEP_TOL["bfloat16"][0]:
        raise AssertionError("the vqa CLI's first batch is not the sampler's")
    ratio = cli_n["samples_per_s"] / mem_n["samples_per_s"]
    log(f"  vqa CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch, H2D "
        f"{cli_n.get('h2d_ms', float('nan')):.3f} ms/batch; ratio to memory "
        f"{ratio:.3f} (target 0.90)")
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the CLI's eval and test output from the checkpoint
    ckpt = os.path.join(out, f"checkpoint-{CLI_STEPS:07d}")
    shutil.copy(paths["vocab"], ckpt)
    argv = (["--output_dir", os.path.join(root, "vqa_eval"),
             "--model_name_or_path", ckpt, "--do_eval", "--eval_jsonl",
             paths["vqa_val"], "--test_jsonl", paths["vqa_val"],
             "--eval_batch_size", str(FT_EVAL_B)] + data + FT_ARGS
            + CLI_PLATFORM)
    reset_counts(attn)
    res = vqa.main(argv)
    torch.cuda.synchronize()
    n_batches = 2 * math.ceil(FT_EVAL / FT_EVAL_B)
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    log(f"  vqa CLI eval + test: {got[0]} launches ({got[1]} with dropout, "
        f"plain {got[2]}) over {n_batches} batches of {FT_EVAL_B}; "
        f"vqa_accuracy {res['eval']['vqa_accuracy']:.4f}")
    if got != (per_step * n_batches, 0, 0):
        raise AssertionError(f"vqa eval launched {got}")
    val = VQADataset(paths["vqa_val"], FeatureStore(paths["features"]),
                     tokenizer, QA_ANSWERS,
                     sg2id=load_phrase_vocab(paths["id2phrase"]),
                     cfg=tensorize_cfg(args))
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, VQAModel, ckpt)
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20)
    err = float(np.abs(logits - res["eval"]["logits"]).max())
    acc = vqa.vqa_accuracy(logits, arrays["label"])
    with open(os.path.join(root, "vqa_eval", "vqa_val_results.json")) as f:
        results = json.load(f)
    with open(paths["label2ans"]) as f:
        label2ans = json.load(f)
    answers_ok = (len(results) == FT_EVAL and [r["question_id"] for r in
                                               results]
                  == [int(q) for q in arrays["question_id"]]
                  and [r["answer"] for r in results]
                  == [label2ans[int(a)] for a in logits.argmax(1)])
    log(f"  vqa eval against the forward in memory: max|logit diff| "
        f"{err:.3e} (tol {SCORE_TOL:g}), accuracy {acc:.4f} vs CLI "
        f"{res['eval']['vqa_accuracy']:.4f}; test output: {len(results)} "
        f"answers from label2ans {'ok' if answers_ok else 'WRONG'}")
    if err > SCORE_TOL or acc != res["eval"]["vqa_accuracy"] or not answers_ok:
        raise AssertionError("vqa CLI eval differs from the forward in memory")
    del model, arrays, res
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the schedules: kl -> bce and the hidden dropouts at step 2
    kinds, kernel_p, seen = [], [], []
    real_kl, real_bce = vqa.kl_div_loss, vqa.instance_bce_with_logits
    real_attn = layers_mod.masked_attention

    def kl(*a):
        kinds.append("kl")
        return real_kl(*a)

    def bce(*a):
        kinds.append("bce")
        return real_bce(*a)

    def attention(*a, **kw):
        kernel_p.append(kw.get("dropout_p", 0.0))
        return real_attn(*a, **kw)

    def before(trainer):
        kinds.clear()
        kernel_p.clear()

    def after(trainer, metrics):
        seen.append((trainer.step_count - 1, tuple(kinds),
                     sorted({m.p for m in hidden_dropouts(trainer.model)}),
                     sorted(set(kernel_p))))
    argv = (["--output_dir", os.path.join(root, "vqa_sched"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--loss_type", "kl", "--adjust_loss_step", "2",
             "--adjust_dp_step", "2"] + common)
    vqa.kl_div_loss, vqa.instance_bce_with_logits = kl, bce
    layers_mod.masked_attention = attention
    try:
        with counted_steps(attn, per_step, "a vqa schedule step"), \
                around_steps(before, after):
            sched = vqa.main(argv)["train"]
    finally:
        vqa.kl_div_loss, vqa.instance_bce_with_logits = real_kl, real_bce
        layers_mod.masked_attention = real_attn
    check_losses(sched, FT_SHORT, "vqa kl -> bce")
    want = [(s, ("kl",) if s < 2 else ("bce",),
             [DROP_P if s < 2 else 0.3], [DROP_P]) for s in range(FT_SHORT)]
    for s in seen:
        log(f"  vqa schedule: step {s[0]} loss {s[1]} hidden dropouts {s[2]} "
            f"kernel p {s[3]}")
    if seen != want:
        raise AssertionError(f"vqa schedules: {seen}, want {want}")
    return dict(launches_per_step=per_step, launches=total[0],
                in_memory=mem_n, cli=cli_n, ratio=ratio,
                main_fetch_ms=fetch_ms, eval_logit_err=err,
                vqa_accuracy=acc, losses=losses)


def load_checkpoint(torch, model_cls, ckpt):
    """A bf16 `model_cls` on the card with a CLI checkpoint's weights."""
    from mvp_pytorch_tpu_torch.models import ModelConfig
    model = model_cls(ModelConfig.from_pretrained(ckpt, dtype="bfloat16"),
                      device=DEVICE)
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     map_location=DEVICE, weights_only=True))
    return model


def phase9_ve(torch, attn, paths, root):
    """(b) SNLI-VE: 13 CLI steps with --mask_training --freeze_steps 5, the
    freeze read off the parameters after every step, the eval against the
    forward in memory; 3 steps with --use_single."""
    import gc
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore, VEDataset,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ClassificationModel
    from mvp_pytorch_tpu_torch.tasks import ve
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    b, freeze = FT_B["ve"], 5
    common = (["--train_jsonl", paths["ve"], "--feature_tsv",
               paths["features"], "--id2phrase", paths["id2phrase"],
               "--data_dir", root] + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["ve"], "--train_batch_size",
                 str(b), "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    bert0, cls_prev, seen = {}, [], []

    def classifier(model):
        return [p for n, p in model.named_parameters()
                if n.startswith("classifier.")]

    def before(trainer):
        if not bert0:
            bert0.update({n: p.detach().clone() for n, p in
                          trainer.model.named_parameters()
                          if n.startswith("bert.")})
        cls_prev[:] = [p.detach().clone() for p in classifier(trainer.model)]

    def after(trainer, metrics):
        params = dict(trainer.model.named_parameters())
        seen.append((trainer.step_count,
                     all(torch.equal(params[n], p) for n, p in bert0.items()),
                     any(not torch.equal(a, c) for a, c in
                         zip(cls_prev, classifier(trainer.model)))))

    out = os.path.join(root, "ve_train")
    argv = (["--output_dir", out, "--do_train", "--do_eval", "--max_steps",
             str(FT_STEPS), "--ckpt_period", str(FT_STEPS), "--eval_jsonl",
             paths["ve_val"], "--eval_batch_size", str(FT_EVAL_B),
             "--mask_training", "--freeze_steps", str(freeze)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.ve " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    args = ve.get_args(argv)
    tokenizer = FastBertTokenizer(paths["vocab"])
    per_step = 3 * build_config(args, tokenizer, num_labels=3).half_layers
    with counted_steps(attn, per_step, "a ve CLI step") as total, \
            around_steps(before, after):
        torch.cuda.reset_peak_memory_stats()
        res = ve.main(argv)
    cli_n = cli_numbers(res["train"], b,
                        torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(res["train"], FT_STEPS, "ve CLI")
    want = [(s, s <= freeze, True) for s in range(1, FT_STEPS + 1)]
    log("  ve freeze: (step, bert.* bitwise unchanged, classifier moved) "
        + " ".join(f"{s}:{int(u)}{int(c)}" for s, u, c in seen))
    if seen != want:
        raise AssertionError(f"ve freeze {seen}, want {want}")
    log(f"  ve CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch; acc (train) "
        + " ".join(f"{m['acc']:.3f}" for m in res["train"]))
    bert0.clear()
    gc.collect()
    torch.cuda.empty_cache()
    val = VEDataset(paths["ve_val"], FeatureStore(paths["features"]),
                    tokenizer, sg2id=load_phrase_vocab(paths["id2phrase"]),
                    cfg=tensorize_cfg(args))
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, ClassificationModel,
                            os.path.join(out, f"checkpoint-{FT_STEPS:07d}"))
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20)
    acc = float((logits.argmax(1) == arrays["label"]).sum()) / len(val)
    with open(os.path.join(out, "eval_logs.json")) as f:
        logged = json.load(f)[-1]["ve_accuracy"]
    log(f"  ve eval: CLI ve_accuracy {logged:.4f}, in memory {acc:.4f} "
        f"({len(val)} pairs)")
    if acc != logged:
        raise AssertionError("ve CLI eval differs from the forward in memory")
    del model, arrays
    gc.collect()
    torch.cuda.empty_cache()
    argv = (["--output_dir", os.path.join(root, "ve_single"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--use_single"] + common)
    with counted_steps(attn, per_step, "a ve --use_single step") as stotal:
        single = ve.main(argv)["train"]
    check_losses(single, FT_SHORT, "ve --use_single")
    log(f"  ve --use_single: {stotal[0]} launches")
    return dict(launches_per_step=per_step, launches=total[0], cli=cli_n,
                ve_accuracy=acc, losses=losses,
                single_losses=[m["loss"] for m in single])


def phase9_re(torch, attn, paths, root):
    """(c) RE: 13 CLI steps of `REModel` mod 1 reading fusion layer 2, with
    the detections, the three accuracies against the forward in memory; 3
    steps at --loss_mod 3."""
    import gc
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore, REDataset,
                                                     load_phrase_vocab,
                                                     re_score, re_score_det1,
                                                     re_score_det2)
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import REModel
    from mvp_pytorch_tpu_torch.tasks import re_task
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    b = FT_B["re"]
    phrase_layer = "2" if DEVICE == "cuda" else "0"
    common = (["--train_json", paths["re"], "--feature_tsv",
               paths["features"], "--id2phrase", paths["id2phrase"],
               "--data_dir", root] + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["re"], "--train_batch_size",
                 str(b), "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    out = os.path.join(root, "re_train")
    argv = (["--output_dir", out, "--do_train", "--do_eval", "--max_steps",
             str(FT_STEPS), "--ckpt_period", str(FT_STEPS), "--eval_json",
             paths["re"], "--det_json", paths["re_dets"], "--max_det",
             str(FT_MAX_DET), "--eval_batch_size", str(FT_EVAL_B),
             "--loss_mod", "1", "--phrase_layer", phrase_layer] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.re_task " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    args = re_task.get_args(argv)
    tokenizer = FastBertTokenizer(paths["vocab"])
    per_step = 3 * build_config(args, tokenizer, num_labels=1).half_layers
    with counted_steps(attn, per_step, "an re CLI step") as total:
        torch.cuda.reset_peak_memory_stats()
        res = re_task.main(argv)
    cli_n = cli_numbers(res["train"], b,
                        torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(res["train"], FT_STEPS, "re CLI")
    log(f"  re CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch")
    gc.collect()
    torch.cuda.empty_cache()
    val = REDataset(paths["re"], FeatureStore(paths["features"]), tokenizer,
                    sg2id=load_phrase_vocab(paths["id2phrase"]),
                    cfg=tensorize_cfg(args), det_json=paths["re_dets"],
                    max_det=FT_MAX_DET)
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, REModel,
                            os.path.join(out, f"checkpoint-{FT_STEPS:07d}"))
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20, mod=1,
                            phrase_layer=int(phrase_layer))
    det = (logits, arrays["label"], arrays["det_label"], arrays["iou_mat"])
    mine = {"re_accuracy": re_score(*det[:2]),
            "re_accuracy_det1": re_score_det1(*det),
            "re_accuracy_det2": re_score_det2(*det)}
    with open(os.path.join(out, "eval_logs.json")) as f:
        logged = {k: v for k, v in json.load(f)[-1].items() if k != "step"}
    log(f"  re eval: CLI {json.dumps(logged)}; in memory {json.dumps(mine)}")
    if logged != mine:
        raise AssertionError("re CLI eval differs from the forward in memory")
    del model, arrays
    gc.collect()
    torch.cuda.empty_cache()
    argv = (["--output_dir", os.path.join(root, "re_mod3"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--loss_mod", "3"] + common)
    with counted_steps(attn, per_step, "an re --loss_mod 3 step") as mtotal:
        mod3 = re_task.main(argv)["train"]
    check_losses(mod3, FT_SHORT, "re --loss_mod 3")
    log(f"  re --loss_mod 3: {mtotal[0]} launches")
    return dict(launches_per_step=per_step, launches=total[0], cli=cli_n,
                scores=mine, losses=losses,
                mod3_losses=[m["loss"] for m in mod3])


def finetune_summary(ft):
    """Phase 9's numbers for the kernels line: each task's launches a step,
    step ms, samples/s and peak GB, and the kernel's ms, bound ms, plain
    ms and SDPA ms at each of FT_SHAPES (fused L 90, B 64 first) at p 0.1
    and 0."""
    out = {task: {"launches_per_step": r["launches_per_step"],
                  "launches": r["launches"], **r["cli"]}
           for task, r in ft["tasks"].items()}
    out["vqa"].update(ratio=ft["tasks"]["vqa"]["ratio"],
                      in_memory=ft["tasks"]["vqa"]["in_memory"])
    out["attention"] = ft["attention"]
    out["seconds"] = ft["seconds"]
    return out


def phase9_finetune_cli(torch, attn, layers_mod):
    """The VQA, SNLI-VE and RE command lines at MVPTR-base on a generated
    root, and the kernel at their attention shapes."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase9")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, finetune=True)
        log(f"  root: {CLI_IMAGES} images, {CLI_REGIONS} regions x 2054 fp32 "
            f"({feat_bytes / 1e6:.1f} MB of features, {tsv_bytes / 1e6:.1f} "
            f"MB of TSV), {FT_QUESTIONS} questions over {QA_ANSWERS} answers, "
            f"{FT_VE_PAIRS} hypotheses, {CLI_IMAGES} expressions written in "
            f"{time.perf_counter() - t0:.1f} s")
        times = attention_times(torch, attn, FT_SHAPES, seed=9)
        res = {"vqa": phase9_vqa(torch, attn, layers_mod, paths, root)}
        gc.collect()
        torch.cuda.empty_cache()
        res["ve"] = phase9_ve(torch, attn, paths, root)
        gc.collect()
        torch.cuda.empty_cache()
        res["re"] = phase9_re(torch, attn, paths, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 9 took {seconds:.1f} s")
    return dict(tasks=res, attention=times, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 10: NLVR2 through its command line, and serving over HTTP
# ---------------------------------------------------------------------------

NLVR_TRAIN, NLVR_EVAL = 2000, 1000
NLVR_B, NLVR_LR = 32, "4e-5"
NLVR_GRAD_PARAMS = ("classifier.weight", "bert.pooler.dense.weight",
                    "bert.txt_encoder.layer.0.attention.self.query.weight",
                    "bert.vis_encoder.layer.0.attention.self.query.weight",
                    "bert.mul_encoder.layer.0.attention.self.query.weight")
# serving: the JAX server's lengths (LA 35 = 30 + 5 phrase slots, T 20,
# R 50: fused L 85), both modes, micro-batches of up to 16
SERVE_MAX_BATCH, SERVE_WAIT_MS = 16, 5
SERVE_SINGLE, SERVE_CLIENTS, SERVE_BATCH_REQUESTS = 256, 32, 4
SERVE_DEADLINE_S = 300
NLVR_FP32_TOL = 1e-5                 # the real batch, fp32 logits and loss
NLVR_REAL_BATCHES = 3                # real batches held kernel against plain
SERVE_EMB_TOL = 1e-6                 # an embedding answer, same dtype
# bf16 against the fp32 plain path: the kernel path's largest distance from
# it at most BF16_FAR_RATIO times the plain bf16 path's, plus one bf16 ulp at
# the largest |value| (for a loss, 1e-4 of itself). The readings of the
# NLVR2 real batches and of the served outputs are in PERF.md
BF16_FAR_RATIO = 1.25


def max_dist(a, ref) -> float:
    return (a.float() - ref.float()).abs().max().item()


def bf16_far(what, k_far, p_far, finite, add, rule):
    """Hold the bf16 kernel path against the bf16 plain path by their
    largest distances from the fp32 reference, `k_far` and `p_far`; fail
    unless the kernel path's output is `finite` and
    k_far <= BF16_FAR_RATIO p_far + `add`."""
    lim = BF16_FAR_RATIO * p_far + add
    ok = finite and k_far <= lim
    log(f"  {what}: from fp32 kernel {k_far:.3e}, plain {p_far:.3e} (ratio "
        f"{k_far / p_far if p_far else float('nan'):.3f}), tol "
        f"{BF16_FAR_RATIO:g} x plain + {add:.3e} ({rule}) = {lim:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(what)
    return {"kernel_far": k_far, "plain_far": p_far, "bound": lim}


def write_nlvr_files(root, rng, words, tags):
    """NLVR2 statements over pairs of distinct images of `write_cli_root`, by
    the learnable rule of the port's `data/synthetic.py`: the statement names
    a tag of exactly one of the two images, and its label is true iff that
    image is img0. NLVR_TRAIN statements (`nlvr.jsonl`) and NLVR_EVAL more
    (`nlvr_val.jsonl`)."""
    keys = sorted(tags)
    plain = words[2000:]

    def text(n):
        return " ".join(plain[int(w)] for w in rng.integers(0, len(plain), n))

    lines = []
    while len(lines) < NLVR_TRAIN + NLVR_EVAL:
        i0, step = rng.integers(0, len(keys)), rng.integers(1, len(keys))
        img0, img1 = keys[int(i0)], keys[int((i0 + step) % len(keys))]
        in_img0 = bool(rng.integers(0, 2))
        src, other = (img0, img1) if in_img0 else (img1, img0)
        cands = sorted(set(tags[src]) - set(tags[other]))
        if not cands:
            continue
        tag = cands[int(rng.integers(0, len(cands)))]
        lines.append(json.dumps({
            "sentence": f"{text(5)} {tag} {text(6)}", "img0": img0,
            "img1": img1, "label": in_img0}))
    out = {"nlvr": os.path.join(root, "nlvr.jsonl"),
           "nlvr_val": os.path.join(root, "nlvr_val.jsonl")}
    with open(out["nlvr"], "w") as f:
        f.write("\n".join(lines[:NLVR_TRAIN]) + "\n")
    with open(out["nlvr_val"], "w") as f:
        f.write("\n".join(lines[NLVR_TRAIN:]) + "\n")
    return out


@contextlib.contextmanager
def key_lengths(layers_mod):
    """Record the key length of every attention call of the models."""
    seen, real = [], layers_mod.masked_attention

    def attention(q, k, v, bias=None, **kw):
        seen.append(k.shape[1] if kw.get("layout") == "blhd"
                    else k.shape[2])
        return real(q, k, v, bias, **kw)
    layers_mod.masked_attention = attention
    try:
        yield seen
    finally:
        layers_mod.masked_attention = real


def nlvr_lengths(half):
    """The key lengths of one NLVR2 forward: text 40, both images 70, the
    fusion pass 140, each over `half` layers."""
    return sorted([NLVR_LA] * half + [70] * (2 * half) + [NLVR_L] * half)


def phase10_nlvr(torch, attn, layers_mod, paths, root):
    """(A) NLVR2: kernel path against plain path on the first real batch,
    the first batch 13 times in memory, 26 steps through the CLI, the CLI's
    eval against the model's forward in memory."""
    import dataclasses
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import NLVRModel
    from mvp_pytorch_tpu_torch.tasks import nlvr
    from mvp_pytorch_tpu_torch.tasks.common import (NLVR_INPUT_NAMES,
                                                    NLVR_MODEL_KEYS,
                                                    TaskFetch, build_config,
                                                    tensorize_cfg)
    from mvp_pytorch_tpu_torch.training.loop import batch_on, train_on_batches
    b = NLVR_B
    data = ["--train_jsonl", paths["nlvr"], "--feature_tsv", paths["features"],
            "--data_dir", root]
    common = (data + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", NLVR_LR, "--train_batch_size", str(b),
                 "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    args = nlvr.get_args(["--output_dir", root] + common)
    tokenizer = FastBertTokenizer(paths["vocab"])
    cfg = build_config(args, tokenizer, num_labels=2)
    half = cfg.half_layers
    per_step = half * 4                 # text, two images, one fusion pass
    dataset = nlvr.NLVRDataset(paths["nlvr"], FeatureStore(paths["features"]),
                               tokenizer, tensorize_cfg(args))
    fetch = TaskFetch(dataset, NLVR_INPUT_NAMES)
    sampler = BatchSampler(len(dataset), b, seed=args.seed)
    t0 = time.perf_counter()
    first = fetch(sampler.batch_at(0))
    fetch_ms = (time.perf_counter() - t0) * 1e3
    shapes = {k: v.shape for k, v in first.items()}
    log(f"  nlvr: a batch fetched on the main thread: {fetch_ms:.1f} ms; "
        f"shapes {shapes}; labels true {int(first['label'].sum())} of {b}")
    if (shapes["input_ids_a"] != (b, NLVR_LA)
            or shapes["attention_mask_b2"] != (b, 20 + NLVR_R)
            or shapes["img_feats2"] != (b, NLVR_R, 2054)
            or shapes["label"] != (b,)):
        raise AssertionError(f"nlvr batch shapes {shapes}")

    # 1. the first real batches at dropout 0: kernel path against plain path
    batches = [batch_on(DEVICE, first)] + [
        batch_on(DEVICE, fetch(sampler.batch_at(i)))
        for i in range(1, NLVR_REAL_BATCHES)]
    refs, real_batch = [], {}
    pooled = {n: {"k": 0.0, "p": 0.0, "scale": 0.0, "finite": True}
              for n in ("logits", "example losses")}
    for dn in ("float32", "bfloat16"):
        model = NLVRModel(dataclasses.replace(
            cfg, dtype=dn, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0), device=DEVICE, seed=args.seed)
        model.train()
        for bi, batch in enumerate(batches):
            def step():
                model.zero_grad(set_to_none=True)
                loss, logits = model(*(batch[k] for k in NLVR_MODEL_KEYS),
                                     labels=batch["label"],
                                     max_tag_length=20)
                loss.backward()
                params = dict(model.named_parameters())
                return ((loss.detach(), logits.detach()),
                        {n: params[n].grad.detach().float().clone()
                         for n in NLVR_GRAD_PARAMS})

            reset_counts(attn)
            with key_lengths(layers_mod) as seen:
                (k_loss, k_logits), k_grads = step()
            torch.cuda.synchronize()
            if (attn.masked_attention.launches != per_step
                    or attn.masked_attention.dropout_launches != 0
                    or sorted(seen) != nlvr_lengths(half)):
                raise AssertionError(f"nlvr kernel path: {seen}")
            with plain_attention_path(layers_mod, attn):
                (p_loss, p_logits), p_grads = step()
            torch.cuda.synchronize()
            if attn.masked_attention.launches != per_step:
                raise AssertionError("nlvr plain path launched the kernel")
            what = f"nlvr real batch {bi} {dn:9s}"
            gaps = {}
            for name, a, c in (("logits", k_logits, p_logits),
                               ("loss", k_loss, p_loss)):
                gaps[name] = gap = (a - c).abs().max().item()
                if dn == "float32":
                    ok = bool(a.isfinite().all()) and gap <= NLVR_FP32_TOL
                    log(f"  {what} {name}: max|kernel-plain| {gap:.3e} tol "
                        f"{NLVR_FP32_TOL:g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{what} {name}")
                    continue
                ref = refs[bi][name]
                log(f"  {what} {name}: max|kernel-plain| {gap:.3e}; from "
                    f"fp32 kernel {max_dist(a, ref):.3e}, plain "
                    f"{max_dist(c, ref):.3e} (printed)")
            if dn == "bfloat16":
                # the loss is the mean of the examples' cross entropies,
                # whose errors cancel by chance, so the examples' losses are
                # held: each path's, from its logits, as the model takes them
                nll = [torch.nn.functional.cross_entropy(
                    x.float(), batch["label"].long(), reduction="none")
                    for x in (k_logits, p_logits, refs[bi]["logits"])]
                if abs(k_loss.item() - nll[0].mean().item()) > NLVR_FP32_TOL:
                    raise AssertionError(f"{what}: the loss is not the mean "
                                         f"cross entropy of the logits")
                for name, (k, c, f) in (
                        ("logits", (k_logits, p_logits, refs[bi]["logits"])),
                        ("example losses", nll)):
                    got = pooled[name]
                    got["k"] = max(got["k"], max_dist(k, f))
                    got["p"] = max(got["p"], max_dist(c, f))
                    got["scale"] = max(got["scale"], f.abs().max().item())
                    got["finite"] &= bool(k.isfinite().all())
                    gaps[f"{name} kernel from fp32"] = max_dist(k, f)
                    gaps[f"{name} plain from fp32"] = max_dist(c, f)

            def rel(a, c):
                return ((a - c).norm() / c.norm()).item()
            for n in NLVR_GRAD_PARAMS:
                r = rel(k_grads[n], p_grads[n])
                if dn == "float32":
                    ok = bool(k_grads[n].isfinite().all()) and r <= 1e-3
                    log(f"  {what} grad {n}: rel err {r:.3e} tol 0.001 "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{what} grad {n}")
                else:
                    log(f"  {what} grad {n}: kernel vs plain {r:.3e}; from "
                        f"the fp32 gradient: kernel "
                        f"{rel(k_grads[n], refs[bi][n]):.3e}, plain "
                        f"{rel(p_grads[n], refs[bi][n]):.3e} (printed)")
                gaps[f"grad {n}"] = r
            real_batch[f"{dn} batch {bi}"] = gaps
            if dn == "float32":
                refs.append(dict(p_grads, logits=p_logits, loss=p_loss))
            del k_grads, p_grads, k_logits, p_logits
        del model
        gc.collect()
        torch.cuda.empty_cache()
    # bf16, over the batches together (192 logits, 96 example losses)
    got = pooled["logits"]
    real_batch["bfloat16 logits"] = bf16_far(
        f"nlvr real batches 0-{len(batches) - 1} bfloat16 logits", got["k"],
        got["p"], got["finite"], bf16_ulp(got["scale"]),
        f"1 bf16 ulp at max|logit| {got['scale']:.4f}")
    got = pooled["example losses"]
    real_batch["bfloat16 example losses"] = bf16_far(
        f"nlvr real batches 0-{len(batches) - 1} bfloat16 example losses",
        got["k"], got["p"], got["finite"], FT_BF16_LOSS_REL * got["scale"],
        f"{FT_BF16_LOSS_REL:g} of the largest {got['scale']:.4f}")
    del batches, refs

    # 2. in memory: the first batch CLI_MEM_STEPS times (its loss must fall)
    model = NLVRModel(cfg, device=DEVICE, seed=args.seed)
    with counted_steps(attn, per_step, "an nlvr in-memory step") as total:
        torch.cuda.reset_peak_memory_stats()
        mem = train_on_batches(model, nlvr.nlvr_loss_fn(args), [first],
                               CLI_MEM_STEPS, learning_rate=args.learning_rate,
                               weight_decay=args.weight_decay, seed=args.seed)
    mem_n = cli_numbers(mem, b, torch.cuda.max_memory_allocated() / 1e9,
                        CLI_MEM_TIMED_FROM)
    mem_losses = check_losses(mem, CLI_MEM_STEPS, "nlvr in memory")
    if not mem_losses[-1] < mem_losses[0]:
        raise AssertionError(f"nlvr loss on one batch did not fall: "
                             f"{mem_losses}")
    log(f"  nlvr in memory: {total[0]} launches; {mem_n['step_ms']:.2f} "
        f"ms/step {mem_n['samples_per_s']:.1f} samples/s, peak "
        f"{mem_n['peak_gb']:.2f} GB")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the CLI and its process loader; every step's key lengths
    out = os.path.join(root, "nlvr_train")
    argv = (["--output_dir", out, "--do_train", "--max_steps",
             str(CLI_STEPS), "--ckpt_period", str(CLI_STEPS)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.nlvr " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    bad_lengths = []
    with key_lengths(layers_mod) as seen:
        def before(trainer):
            seen.clear()

        def after(trainer, metrics):
            if sorted(seen) != nlvr_lengths(half):
                bad_lengths.append(list(seen))
        with counted_steps(attn, per_step, "an nlvr CLI step") as total, \
                around_steps(before, after):
            torch.cuda.reset_peak_memory_stats()
            hist = nlvr.main(argv)["train"]
    if bad_lengths:
        raise AssertionError(f"nlvr CLI steps' key lengths: {bad_lengths}")
    cli_n = cli_numbers(hist, b, torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(hist, CLI_STEPS, "nlvr CLI")
    log(f"  nlvr step 1 loss: CLI {losses[0]:.6f}, in memory "
        f"{mem_losses[0]:.6f}")
    if abs(losses[0] - mem_losses[0]) > STEP_TOL["bfloat16"][0]:
        raise AssertionError("the nlvr CLI's first batch is not the "
                             "sampler's")
    ratio = cli_n["samples_per_s"] / mem_n["samples_per_s"]
    log(f"  nlvr CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, {half} of them at Lk {NLVR_L}; plain 0); "
        f"{cli_n['step_ms']:.2f} ms/step {cli_n['samples_per_s']:.1f} "
        f"samples/s, peak {cli_n['peak_gb']:.2f} GB; main thread data "
        f"{cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch, H2D "
        f"{cli_n.get('h2d_ms', float('nan')):.3f} ms/batch; ratio to memory "
        f"{ratio:.3f} (target 0.90)")
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the CLI's eval of the checkpoint over the eval split
    ckpt = os.path.join(out, f"checkpoint-{CLI_STEPS:07d}")
    shutil.copy(paths["vocab"], ckpt)
    argv = (["--output_dir", os.path.join(root, "nlvr_eval"),
             "--model_name_or_path", ckpt, "--do_eval", "--eval_jsonl",
             paths["nlvr_val"], "--eval_batch_size", str(FT_EVAL_B)]
            + data + FT_ARGS + CLI_PLATFORM)
    reset_counts(attn)
    res = nlvr.main(argv)
    torch.cuda.synchronize()
    n_batches = math.ceil(NLVR_EVAL / FT_EVAL_B)
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    log(f"  nlvr CLI eval: {got[0]} launches ({got[1]} with dropout, plain "
        f"{got[2]}) over {n_batches} batches of {FT_EVAL_B}; nlvr_accuracy "
        f"{res['eval']['nlvr_accuracy']:.4f}")
    if got != (per_step * n_batches, 0, 0):
        raise AssertionError(f"nlvr eval launched {got}")
    val = nlvr.NLVRDataset(paths["nlvr_val"], FeatureStore(paths["features"]),
                           tokenizer, tensorize_cfg(args))
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, NLVRModel, ckpt)
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            input_names=NLVR_INPUT_NAMES, max_tag_length=20)
    err = float(np.abs(logits - res["eval"]["logits"]).max())
    acc = int((logits.argmax(1) == arrays["label"]).sum()) / len(val)
    log(f"  nlvr eval against the forward in memory: max|logit diff| "
        f"{err:.3e} (tol {SCORE_TOL:g}), accuracy {acc:.4f} vs CLI "
        f"{res['eval']['nlvr_accuracy']:.4f}")
    if err > SCORE_TOL or acc != res["eval"]["nlvr_accuracy"]:
        raise AssertionError("nlvr CLI eval differs from the forward in "
                             "memory")
    del model, arrays, res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches_per_step=per_step, l140_per_step=half,
                launches=total[0], eval_launches=got[0],
                in_memory=mem_n, cli=cli_n, ratio=ratio,
                main_fetch_ms=fetch_ms, real_batch=real_batch,
                eval_logit_err=err, nlvr_accuracy=acc, losses=losses,
                mem_losses=mem_losses)


def mlm_tokens(text):
    """The token list of a "recovered [MASK] tokens: [...]" answer."""
    import ast
    prefix = "recovered [MASK] tokens: "
    if not text.startswith(prefix):
        raise AssertionError(f"not an mlm answer: {text!r}")
    return ast.literal_eval(text[len(prefix):])


def serve_clients(base, jobs_path, out_path) -> int:
    """The client side of phase 10 B, in a process of its own so that the
    clients share no interpreter lock with the server: post each job of
    `jobs_path` from SERVE_CLIENTS threads, time each until its body is
    read, and parse the bodies after the burst. Pickles the burst's wall
    seconds and each answer with its ms (None for a /v1/batch request) to
    `out_path`; an embedding answer's values as float32 arrays."""
    import pickle
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    with open(jobs_path) as f:
        jobs = json.load(f)

    def run(job):
        if job[0] == "batch":
            path, payload = "/v1/batch", {"mode": job[1], "pairs": job[2]}
        else:
            path, payload = f"/v1/{job[0]}", {"image": job[1], "text": job[2]}
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=SERVE_DEADLINE_S) as r:
            body = r.read()
        return body, (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        raw = list(pool.map(run, jobs))
    wall = time.perf_counter() - t0

    def arrays(res):
        return ({k: np.asarray(v, np.float32) for k, v in res.items()}
                if isinstance(res, dict) else res)
    answers = []
    for job, (body, ms) in zip(jobs, raw):
        got = json.loads(body)
        if job[0] == "batch":
            answers.append(([arrays(r) for r in got["results"]], None))
        else:
            answers.append((arrays(got["result"]), ms))
    with open(out_path, "wb") as f:
        pickle.dump({"wall_s": wall, "answers": answers}, f)
    return 0


def median_ms(fn, n):
    """The median host ms of `n` calls of `fn`."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def phase10_serve(torch, attn, layers_mod, paths, root):
    """(B) Serving: a seeded MVPTR-base pretraining checkpoint behind
    `tasks.serve.main` on a thread (both modes), concurrent single requests
    and /v1/batch requests from a client process, each answer held against
    direct forwards of the kernel path, the plain path and the fp32 plain
    path; then the server as a subprocess, drained by SIGTERM."""
    import dataclasses
    import gc
    import pickle
    import shutil
    import signal
    import socket
    import threading
    import urllib.request
    from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
    from mvp_pytorch_tpu_torch.data.tensorize import collate
    from mvp_pytorch_tpu_torch.models import (BiPretrainModel, MLMModel,
                                              ModelConfig, RepModel)
    from mvp_pytorch_tpu_torch.pipeline import MODEL_INPUTS, load_for_serving
    from mvp_pytorch_tpu_torch.tasks import serve
    from mvp_pytorch_tpu_torch.training.checkpoint import (CheckpointManager,
                                                           WEIGHTS_NAME)
    from mvp_pytorch_tpu_torch.training.loop import batch_on

    # 1. the model directory: what tasks.pretrain writes, plus the vocab
    t0 = time.perf_counter()
    cfg = base_config(ModelConfig, "bfloat16", DROP_P)
    model = BiPretrainModel(cfg, device=DEVICE, seed=5)
    mdir = CheckpointManager(os.path.join(root, "serve_model")).save(
        0, model, config=cfg)
    shutil.copy(paths["vocab"], mdir)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  serve: seeded {cfg.dtype} checkpoint written in "
        f"{time.perf_counter() - t0:.1f} s")

    # 2. the server in-process, on a thread; the clients in another process
    argv = ["--model_dir", mdir, "--feature_tsv", paths["features"],
            "--id2phrase", paths["id2phrase"], "--max_batch",
            str(SERVE_MAX_BATCH), "--batch_wait_ms", str(SERVE_WAIT_MS),
            "--port", "0", "--device", DEVICE]
    up, ready = {}, threading.Event()

    def on_ready(server, pipes, batchers):
        up.update(server=server, pipes=pipes, batchers=batchers)
        reset_counts(attn)
        ready.set()
    t_start = time.perf_counter()
    thread = threading.Thread(target=serve.main, args=(argv,),
                              kwargs=dict(ready=on_ready), daemon=True)
    thread.start()
    try:
        if not ready.wait(SERVE_DEADLINE_S):
            raise AssertionError("the server did not come up")
        up_s = time.perf_counter() - t_start
        server, pipes = up["server"], up["pipes"]
        base = f"http://127.0.0.1:{server.server_address[1]}"
        images = sorted(FeatureStore(paths["features"]).keys())
        with open(paths["vocab"]) as f:
            plain = [w.strip() for w in f][2005:]     # no tag words
        rng = np.random.default_rng(3)

        def text(masks):
            words = [plain[int(i)] for i in rng.integers(0, len(plain), 7)]
            for j in rng.choice(7, masks, replace=False):
                words[int(j)] = "[MASK]"
            return " ".join(words)
        jobs = []
        for i in range(SERVE_SINGLE):
            mode = "mlm" if i % 2 == 0 else "embedding"
            jobs.append((mode, images[int(rng.integers(0, len(images)))],
                         text(1 + int(rng.integers(0, 2)))))
        for i in range(SERVE_BATCH_REQUESTS):
            mode = "mlm" if i % 2 == 0 else "embedding"
            jobs.insert(i * 60 + 30, ("batch", mode, [
                [images[int(rng.integers(0, len(images)))], text(1)]
                for _ in range(SERVE_MAX_BATCH)]))
        jobs_path = os.path.join(root, "serve_jobs.json")
        out_path = os.path.join(root, "serve_answers.pkl")
        with open(jobs_path, "w") as f:
            json.dump(jobs, f)
        client = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--serve_clients",
             base, jobs_path, out_path], capture_output=True, text=True,
            timeout=SERVE_DEADLINE_S)
        if client.returncode != 0:
            raise AssertionError(f"the client process exited "
                                 f"{client.returncode}: {client.stderr}")
        with open(out_path, "rb") as f:
            burst = pickle.load(f)
        wall, answers = burst["wall_s"], burst["answers"]
        torch.cuda.synchronize()
        launches = (attn.masked_attention.launches,
                    attn.masked_attention.dropout_launches,
                    attn.plain_attention.calls)
        with urllib.request.urlopen(f"{base}/healthz",
                                    timeout=SERVE_DEADLINE_S) as r:
            health = json.loads(r.read())
        stats = health["batching"]
        forwards = (sum(s["batches"] for s in stats.values())
                    + SERVE_BATCH_REQUESTS)
        per_forward = cfg.half_layers * 3
        log(f"  serve: {len(jobs)} requests ({SERVE_SINGLE} single, "
            f"{SERVE_BATCH_REQUESTS} batches of {SERVE_MAX_BATCH}) from "
            f"{SERVE_CLIENTS} client threads of another process in "
            f"{wall:.2f} s; /healthz {stats}; {launches[0]} launches "
            f"({launches[1]} with dropout, plain {launches[2]}) over "
            f"{forwards} batched forwards")
        if launches != (per_forward * forwards, 0, 0):
            raise AssertionError(f"serving launched {launches}, want "
                                 f"{per_forward} a forward")
        for mode, st in stats.items():
            if not (st["requests"] == SERVE_SINGLE // 2
                    and st["batches"] < st["requests"]
                    and st["max_batch_seen"] > 1):
                raise AssertionError(f"serve {mode}: {st}")

        # 3. every answer against direct forwards of the same padded batches
        # of 16: the kernel path in the server's dtype (the same numbers),
        # the plain path in bf16, and the fp32 plain path as the reference
        singles = {"mlm": [], "embedding": []}
        for job, (res, ms) in zip(jobs, answers):
            if job[0] == "batch":
                singles[job[1]].extend((tuple(pair), r, None)
                                       for pair, r in zip(job[2], res))
            else:
                singles[job[0]].append(((job[1], job[2]), res, ms))
        f32 = {}
        for mode, cls in (("mlm", MLMModel), ("embedding", RepModel)):
            f32[mode] = cls(dataclasses.replace(pipes[mode].config,
                                                dtype="float32"),
                            device=DEVICE)
            load_for_serving(f32[mode], os.path.join(mdir, WEIGHTS_NAME),
                             log=lambda _: None)
            f32[mode].eval()

        def direct(mode, chunk):
            exs = [pipes[mode].prepare_example(*pair) for pair, _, _ in chunk]
            x = batch_on(DEVICE, collate(exs + [exs[-1]] * (
                SERVE_MAX_BATCH - len(exs))), MODEL_INPUTS)
            args = [x[k] for k in MODEL_INPUTS]
            with torch.no_grad():
                k = pipes[mode].model(*args, max_tag_length=20)
                with plain_attention_path(layers_mod, attn):
                    p = pipes[mode].model(*args, max_tag_length=20)
                    f = f32[mode](*args, max_tag_length=20)
            return exs, k, p, f

        mlm_pipe, emb_pipe = pipes["mlm"], pipes["embedding"]
        clear = unclear = wrong_unclear = p_clear = p_unclear = 0
        far = {"k": 0.0, "p": 0.0, "scale": 0.0, "finite": True}
        reqs = singles["mlm"]
        for i in range(0, len(reqs), SERVE_MAX_BATCH):
            chunk = reqs[i:i + SERVE_MAX_BATCH]
            exs, k, p, f = direct("mlm", chunk)
            far["k"] = max(far["k"], max_dist(k, f))
            far["p"] = max(far["p"], max_dist(p, f))
            far["scale"] = max(far["scale"], f.abs().max().item())
            far["finite"] &= bool(k.isfinite().all())
            top2 = k.topk(2, dim=-1).values.float().cpu().numpy()
            p_top2 = p.topk(2, dim=-1).values.float().cpu().numpy()
            # a position's plain argmax is the kernel's wherever the plain
            # top-2 gap exceeds twice the position's largest |kernel - plain|
            kp = (k.float() - p.float()).abs().amax(-1).cpu().numpy()
            ids, p_ids = k.argmax(-1).cpu().numpy(), p.argmax(-1).cpu().numpy()
            for j, (ex, (_, res, _)) in enumerate(zip(exs, chunk)):
                pos = np.nonzero(ex["input_ids_a"] == mlm_pipe.mask_id)[0]
                got = mlm_tokens(res)
                if len(got) != len(pos):
                    raise AssertionError(f"mlm answer {res!r} for {pos}")
                want = mlm_pipe.tokenizer.convert_ids_to_tokens(
                    [int(t) for t in ids[j, pos]])
                p_want = mlm_pipe.tokenizer.convert_ids_to_tokens(
                    [int(t) for t in p_ids[j, pos]])
                for q, g, w, pw in zip(pos, got, want, p_want):
                    gap = top2[j, q, 0] - top2[j, q, 1]
                    if gap > bf16_ulp(top2[j, q, 0]):
                        clear += 1
                        if g != w:
                            raise AssertionError(
                                f"mlm token {g!r} != {w!r} at a gap of "
                                f"{gap:.3e}")
                    else:
                        unclear += 1
                        wrong_unclear += int(g != w)
                    p_gap = p_top2[j, q, 0] - p_top2[j, q, 1]
                    if p_gap > 2 * kp[j, q]:
                        p_clear += 1
                        if g != pw:
                            raise AssertionError(
                                f"mlm token {g!r} != the plain path's {pw!r} "
                                f"at a plain gap of {p_gap:.3e} (kernel-plain "
                                f"{kp[j, q]:.3e})")
                    else:
                        p_unclear += 1
            del k, p, f
        if clear == 0 or p_clear == 0:
            raise AssertionError(f"{clear} / {p_clear} clear mlm positions")
        checks = {"mlm logits": bf16_far(
            "served mlm logits (B 16, fused L 85)", far["k"], far["p"],
            far["finite"], bf16_ulp(far["scale"]),
            f"1 bf16 ulp at max|logit| {far['scale']:.4f}")}
        emb_err = 0.0
        names = ("cross_modal_output", "pooled_output", "txt_encoder_output",
                 "vis_encoder_output")
        far = {n: {"k": 0.0, "p": 0.0, "scale": 0.0, "finite": True}
               for n in names}
        reqs = singles["embedding"]
        for i in range(0, len(reqs), SERVE_MAX_BATCH):
            chunk = reqs[i:i + SERVE_MAX_BATCH]
            _, k, p, f = direct("embedding", chunk)
            m = len(chunk)
            for _, res, _ in chunk:
                if set(res) != set(names):
                    raise AssertionError(f"embedding keys {set(res)}")
            for n in names:
                served = torch.from_numpy(np.stack(
                    [res[n] for _, res, _ in chunk])).to(DEVICE)
                emb_err = max(emb_err, max_dist(served, k[n][:m]))
                far[n]["k"] = max(far[n]["k"], max_dist(served, f[n][:m]))
                far[n]["p"] = max(far[n]["p"], max_dist(p[n][:m], f[n][:m]))
                far[n]["scale"] = max(far[n]["scale"],
                                      f[n][:m].abs().max().item())
                far[n]["finite"] &= bool(served.isfinite().all())
            del k, p, f
        for n in names:
            checks[n] = bf16_far(
                f"served {n}", far[n]["k"], far[n]["p"], far[n]["finite"],
                bf16_ulp(far[n]["scale"]),
                f"1 bf16 ulp at max|value| {far[n]['scale']:.4f}")
        log(f"  serve answers against direct forwards: mlm {clear} [MASK] "
            f"positions with a top-2 gap past a bf16 ulp, all equal to the "
            f"kernel path's; {unclear} within an ulp ({wrong_unclear} differ, "
            f"printed); {p_clear} equal to the plain path's where its gap "
            f"exceeds twice |kernel - plain|, {p_unclear} others; embedding "
            f"max|served - kernel path| {emb_err:.3e} (tol "
            f"{SERVE_EMB_TOL:g})")
        if emb_err > SERVE_EMB_TOL:
            raise AssertionError(f"serve answers: embedding {emb_err}")
        del f32
        gc.collect()
        torch.cuda.empty_cache()

        # 4. throughput and latency; the device time of a batched forward;
        # the host work of a request and of a forward, each on one thread
        lat = {m: np.array([ms for _, _, ms in singles[m] if ms is not None])
               for m in singles}
        n_pairs = SERVE_SINGLE + SERVE_BATCH_REQUESTS * SERVE_MAX_BATCH
        numbers = dict(
            requests=len(jobs), pairs=n_pairs, requests_s=wall,
            requests_per_s=len(jobs) / wall, pairs_per_s=n_pairs / wall,
            up_s=up_s, load_s=server.startup["load_s"],
            warmup_s=server.startup["warmup_s"], batching=stats,
            launches=launches[0], forwards=forwards,
            mlm_clear=clear, mlm_unclear=unclear,
            mlm_unclear_differ=wrong_unclear, mlm_plain_clear=p_clear,
            mlm_plain_unclear=p_unclear, embedding_err=emb_err,
            bf16_checks=checks)
        for m, v in lat.items():
            numbers[f"{m}_p50_ms"] = float(np.percentile(v, 50))
            numbers[f"{m}_p99_ms"] = float(np.percentile(v, 99))
        pairs = [pair for pair, _, _ in singles["mlm"][:SERVE_MAX_BATCH]]
        x = collate([mlm_pipe.prepare_example(*pr) for pr in pairs])
        on_dev = batch_on(DEVICE, x, MODEL_INPUTS)
        dev = [on_dev[k] for k in MODEL_INPUTS]
        emb_ans = emb_pipe.infer_prepared(
            [emb_pipe.prepare_example(*pairs[0])], batch_size=1)[0]
        cycle = iter(pairs * 2)

        def forward_wall():
            emb_pipe.model(*dev, max_tag_length=20)
            torch.cuda.synchronize()

        def h2d():
            batch_on(DEVICE, x, MODEL_INPUTS)
            torch.cuda.synchronize()
        with torch.no_grad():
            numbers["mlm_forward_ms"] = cuda_ms(
                lambda: mlm_pipe.model(*dev, max_tag_length=20).argmax(-1),
                iters=10)
            numbers["embedding_forward_ms"] = cuda_ms(
                lambda: emb_pipe.model(*dev, max_tag_length=20), iters=10)
            host = dict(
                prepare_ms=median_ms(
                    lambda: mlm_pipe.prepare_example(*next(cycle)), 32),
                embedding_json_ms=median_ms(lambda: json.dumps(
                    {"result": {k: v.tolist() for k, v in emb_ans.items()}}
                ).encode(), 8),
                h2d_ms=median_ms(h2d, 10),
                forward_wall_ms=median_ms(forward_wall, 10))
        n_emb = SERVE_SINGLE // 2 + SERVE_BATCH_REQUESTS // 2 * SERVE_MAX_BATCH
        host["burst_host_s"] = (
            n_pairs * host["prepare_ms"] + n_emb * host["embedding_json_ms"]
            + forwards * (host["h2d_ms"] + host["forward_wall_ms"])) / 1e3
        numbers["host"] = host
        log(f"  serve: {numbers['requests_per_s']:.1f} requests/s "
            f"({numbers['pairs_per_s']:.1f} pairs/s); mlm p50 "
            f"{numbers['mlm_p50_ms']:.1f} ms p99 {numbers['mlm_p99_ms']:.1f} "
            f"ms; embedding p50 {numbers['embedding_p50_ms']:.1f} ms p99 "
            f"{numbers['embedding_p99_ms']:.1f} ms; device ms a batched "
            f"forward of {SERVE_MAX_BATCH}: mlm "
            f"{numbers['mlm_forward_ms']:.3f} (argmax included), embedding "
            f"{numbers['embedding_forward_ms']:.3f}; load "
            f"{numbers['load_s']:.2f} s, warm-up {numbers['warmup_s']:.2f} s, "
            f"up after {up_s:.2f} s")
        log(f"  serve host work: prepare a pair {host['prepare_ms']:.3f} ms, "
            f"an embedding answer to JSON {host['embedding_json_ms']:.3f} ms, "
            f"a batch's H2D {host['h2d_ms']:.3f} ms, an embedding forward's "
            f"wall {host['forward_wall_ms']:.3f} ms: the burst's {n_pairs} "
            f"pairs, {n_emb} embedding answers and {forwards} forwards take "
            f"{host['burst_host_s']:.2f} s of host work on one interpreter, "
            f"against {wall:.2f} s wall")
    finally:
        if "server" in up:
            up["server"].shutdown()
        thread.join(timeout=SERVE_DEADLINE_S)
    if thread.is_alive():
        raise AssertionError("the in-process server did not drain")
    del up
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the server as a subprocess: one request, then SIGTERM
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tasks.serve",
         "--model_dir", mdir, "--feature_tsv", paths["features"],
         "--modes", "mlm", "--max_batch", str(SERVE_MAX_BATCH), "--port",
         str(port), "--device", DEVICE], cwd=here, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + SERVE_DEADLINE_S
        alive = False
        while time.time() < deadline and not alive:
            if proc.poll() is not None:
                raise AssertionError(
                    f"serve subprocess exited {proc.returncode}: "
                    f"{proc.stdout.read()}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2):
                    alive = True
            except OSError:
                time.sleep(0.5)
        if not alive:
            raise AssertionError("the serve subprocess never came up")
        up_sub = time.perf_counter() - t0
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/mlm",
            data=json.dumps({"image": images[1],
                             "text": "a [MASK] here"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_DEADLINE_S) as r:
            answer = json.loads(r.read())["result"]
        mlm_tokens(answer)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=SERVE_DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
    drained = ("draining in-flight requests" in out
               and "drained, exiting cleanly" in out)
    log(f"  serve subprocess: up after {up_sub:.1f} s, answered {answer!r}, "
        f"SIGTERM -> exit {proc.returncode}, drained {drained}")
    if proc.returncode != 0 or not drained:
        raise AssertionError(f"serve subprocess: exit {proc.returncode}\n"
                             f"{out}")
    numbers["subprocess_up_s"] = up_sub
    return numbers


def phase10(torch, attn, layers_mod, parts=("nlvr", "serve")):
    """Phase 10 on one generated root: (A) NLVR2 through its CLI and the
    kernel at its shapes, (B) serving."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase10")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, nlvr=True)
        log(f"  root: {CLI_IMAGES} images, {CLI_REGIONS} regions x 2054 fp32 "
            f"({feat_bytes / 1e6:.1f} MB of features, {tsv_bytes / 1e6:.1f} "
            f"MB of TSV), {NLVR_TRAIN} + {NLVR_EVAL} NLVR2 statements written "
            f"in {time.perf_counter() - t0:.1f} s")
        if "nlvr" in parts:
            t0 = time.perf_counter()
            res["nlvr"] = phase10_nlvr(torch, attn, layers_mod, paths, root)
            res["nlvr"]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        if "serve" in parts:
            t0 = time.perf_counter()
            res["serve"] = phase10_serve(torch, attn, layers_mod, paths,
                                         root)
            res["serve"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 11: the single-stream model (ImgBertModel) on the card: the kernel
# at its length, --visual_learning and --extra_mode through the pretraining
# command line, and the classifier with 3-D and per-layer masks
# ---------------------------------------------------------------------------

# the pretraining geometry (LA 75 = 70 text + 5 phrase slots, T 20, R 50) as
# one sequence: 145 keys, past the 128-key tile (17 rows and keys in the
# second tiles), so every layer runs on the online kernels
SS_LA, SS_T, SS_R = 75, 20, 50
SS_L = SS_LA + SS_T + SS_R
SS_CLS_B = 64                        # the classifier's batch
SS_EXTRA_STEPS = 3
SS_LOSSES = ("total_loss", "mlm_loss", "itm_loss", "mrc_loss", "mrf_loss")
SS_GRAD_PARAMS = ("bert.embeddings.word_embeddings.weight",
                  "bert.img_embedding.weight", "cls.MRF_bias",
                  "cls.MRC_predictor.weight",
                  "bert.encoder.layer.0.attention.self.query.weight")
# the kernel's timed single-stream shapes (B 96: bf16 at p 0.1 in training
# and 0, fp32 at 0) and the serving forward's (B 16: fused L 85, text L 35,
# vision L 70)
SS_TIMED = ((("single", TRAIN_B, SS_L, "bfloat16", (DROP_P, 0.0), "single"),
             ("single", TRAIN_B, SS_L, "float32", (0.0,), "single")))
SERVE_TIMED = tuple((name, 16, l, "bfloat16", (0.0,), "key")
                    for name, l in (("fused", 85), ("text", 35),
                                    ("vis", 70)))


def single_stream_key_mask(torch, gen, b):
    """[b, 145] int32 key mask of the single-stream sequence: the text, the
    tags and the regions each padded to random lengths, so that masked keys
    sit inside the sequence and in the second key tile (keys 128-144, the
    last 17 regions)."""
    parts = []
    for n, low in ((SS_LA, 8), (SS_T, 3), (SS_R, 10)):
        lens = torch.randint(low, n + 1, (b,), device=DEVICE, generator=gen)
        parts.append(torch.arange(n, device=DEVICE)[None, :] < lens[:, None])
    return torch.cat(parts, 1).to(torch.int32)


def seq2seq_mask(torch, key_mask, la):
    """A [B, L, L] seq2seq mask over a [B, L] key mask (the captioning
    model's layout): the first `la` positions causal among themselves and
    attending to the rest, the rest bidirectional among themselves and
    blind to the first `la`."""
    b, l = key_mask.shape
    pos = torch.arange(l, device=key_mask.device)
    q_txt, k_txt = pos[:, None] < la, pos[None, :] < la
    causal = pos[None, :] <= pos[:, None]
    allowed = torch.where(q_txt, ~k_txt | causal, ~k_txt)
    return (allowed[None] & (key_mask[:, None, :] > 0)).to(torch.int32)


def block_mask(torch, key_mask, la):
    """A [B, L, L] stage mask: the first `la` positions and the rest each
    attend only among themselves."""
    pos = torch.arange(key_mask.shape[1], device=key_mask.device)
    same = (pos[:, None] < la) == (pos[None, :] < la)
    return (same[None] & (key_mask[:, None, :] > 0)).to(torch.int32)


def phase11_kernel(torch, attn):
    """(a) The kernel at Lq = Lk = 145, B 96: against the plain version (and
    its grads against fp32 autograd of the plain version) in both dtypes and
    layouts, at p 0 and p 0.1, with padded key masks and with a [B, 1, L, L]
    seq2seq mask; the dropout mask read back bit for bit; the kernel timed
    beside the plain version, SDPA and its bound, at 145 and at the serving
    forward's shapes."""
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    b, l = TRAIN_B, SS_L

    def new_seed():
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=DEVICE, generator=gen)

    errors = {}
    for dn, dt in dtypes.items():
        for layout in ("blhd", "bhld"):
            for mk in ("key", "seq2seq"):
                for p in (0.0, DROP_P):
                    x = [torch.randn(b, l, H, D, device=DEVICE, generator=gen)
                         for _ in range(4)]          # q, k, v, grad of out
                    x[:2] = [torch.clamp(torch.round(t * 8) / 8, -4, 4)
                             for t in x[:2]]
                    x = [t.to(dt) for t in x]
                    if layout == "bhld":
                        x = [t.transpose(1, 2).contiguous() for t in x]
                    q, k, v, g = x
                    mask = single_stream_key_mask(torch, gen, b)
                    if mk == "seq2seq":
                        mask = seq2seq_mask(torch, mask, SS_LA)
                    bias = attn.mask_to_bias(mask)
                    seed = new_seed() if p else None
                    plain = (attn.plain_attention_blhd if layout == "blhd"
                             else attn.plain_attention)
                    leaves = [t.requires_grad_() for t in (q, k, v)]
                    before = (attn.masked_attention.launches,
                              attn.masked_attention.dropout_launches)
                    out = attn.masked_attention(*leaves, bias, layout=layout,
                                                dropout_p=p, seed=seed)
                    want = plain(q.detach(), k.detach(), v.detach(), bias, p,
                                 seed)
                    got_g = torch.autograd.grad(out, leaves, g)
                    ref = [t.detach().float().requires_grad_()
                           for t in leaves]
                    want_g = torch.autograd.grad(plain(*ref, bias, p, seed),
                                                 ref, g.float())
                    torch.cuda.synchronize()
                    launched = (attn.masked_attention.launches - before[0],
                                attn.masked_attention.dropout_launches
                                - before[1])
                    f_err = (out.float() - want.float()).abs().max().item()
                    b_err = max((a.float() - c).abs().max().item()
                                for a, c in zip(got_g, want_g))
                    finite = (bool(torch.isfinite(out.float()).all())
                              and all(bool(torch.isfinite(a).all())
                                      for a in got_g))
                    ok = (finite and f_err <= TOL[dn]
                          and b_err <= GRAD_TOL[dn]
                          and launched == (1, int(p > 0)))
                    log(f"  kernel vs plain  single {mk:7s} B={b} L={l} "
                        f"{dn:9s} {layout} p={p:g}: fwd max|err|={f_err:.3e} "
                        f"(tol {TOL[dn]:g})  grads max|err|={b_err:.3e} "
                        f"(tol {GRAD_TOL[dn]:g})  launches {launched}  "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"kernel at L {l} disagrees: {mk} {dn} {layout} "
                            f"p {p}: fwd {f_err} grads {b_err} finite "
                            f"{finite} launches {launched}")
                    errors[f"{mk} {dn} {layout} p {p:g}"] = dict(
                        fwd=f_err, grads=b_err)
                    del x, q, k, v, g, bias, leaves, out, want, got_g, ref
                    del want_g
    masks = {f"{dn} {layout}": online_mask_readback(
        torch, attn, b, l, dn, dt, layout, new_seed())
        for dn, dt in dtypes.items() for layout in ("bhld", "blhd")}
    torch.cuda.empty_cache()
    times = attention_times(torch, attn, SS_TIMED + SERVE_TIMED, seed=12)
    torch.cuda.empty_cache()
    return dict(errors=errors, dropout_masks=masks, times=times)


class _Log:
    """A logger for the command lines' set-up: every line to `log`."""
    info = staticmethod(log)


def region_checks(run, idx, epoch, batch, max_tag_length):
    """The first `--visual_learning` batch against its data: the masked
    shares of text tokens and regions; region labels only on zeroed
    regions; `masked_region_targets` equal to the stored features and the
    regions' features equal to them where not masked. Returns the shares."""
    from mvp_pytorch_tpu_torch.tasks.pretrain import single_stream_batch
    raw = run.main_dataset.fetch(idx, epoch)
    fused = single_stream_batch(raw, max_tag_length)
    same = all(np.array_equal(fused[k], batch[k]) for k in batch)
    text_share, region_share, labels_on_regions = mask_shares(
        {"lm_label_ids_a": raw["lm_label_ids_a"],
         "phrase_index": raw["phrase_index"], "img_feats": raw["img_feat"],
         "lm_label_ids_b": raw["lm_label_ids_b"]}, max_tag_length)
    flags = batch["masked_region_flags"] > 0
    zeroed = (batch["img_feats"][:, :, :-6] == 0).all(-1)
    labelled = batch["masked_region_labels"] >= 0
    stored = []
    for i in idx:
        image_id = run.main_dataset.tsv.seek(int(i))[0]
        stored.append(run.main_dataset.features.get(image_id)[0][:SS_R])
    stored = np.stack(stored)
    targets = batch["masked_region_targets"]
    target_ok = bool(np.array_equal(targets, stored))
    kept_ok = bool(np.array_equal(batch["img_feats"][~flags],
                                  stored[~flags]))
    ok = (same and np.array_equal(flags, zeroed) and labels_on_regions
          and not (labelled & ~flags).any() and target_ok and kept_ok
          and abs(text_share - MASK_SHARE) <= MASK_SHARE_TOL
          and abs(region_share - MASK_SHARE) <= MASK_SHARE_TOL)
    log(f"  first batch: the fetch is the fused data-plane batch: {same}; "
        f"masked share of text tokens {text_share:.4f}, of regions "
        f"{region_share:.4f} (want {MASK_SHARE} +- {MASK_SHARE_TOL}); "
        f"flags on exactly the zeroed regions: "
        f"{bool(np.array_equal(flags, zeroed))}; labels only there: "
        f"{not (labelled & ~flags).any()} ({int(labelled.sum())} labelled of "
        f"{int(flags.sum())} masked); targets equal the stored features: "
        f"{target_ok}; unmasked regions unchanged: {kept_ok}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the first --visual_learning batch is off")
    return text_share, region_share


def phase11_visual_learning(torch, attn, layers_mod, paths, root):
    """(b) `--visual_learning`: the first batch's masks and targets, one
    dropout-0 step kernel path against plain path, 13 steps in memory and 26
    through the CLI and its process loader."""
    import dataclasses
    import gc
    import types
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ImgBertForPreTraining
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.training.loop import batch_on, train_on_batches
    data = ["--corpus_tsv", paths["corpus"], "--feature_tsv",
            paths["features"], "--id2phrase", paths["id2phrase"],
            "--tag2id", paths["tag2id"]]
    common = (["--train_batch_size", str(TRAIN_B), "--log_period", "1",
               "--num_workers", "4", "--worker_start_method", "fork",
               "--data_dir", root] + data + PRE_ARGS + CLI_PLATFORM)
    args = pre.get_args(["--output_dir", root, "--visual_learning"]
                        + common)
    tokenizer = FastBertTokenizer(paths["vocab"])
    run = pre.prepare(args, tokenizer, DEVICE, _Log)
    cfg, mt = run.model.config, args.max_tag_length
    per_step = cfg.num_hidden_layers
    max_pred = args.max_pred_a + args.max_pred_b
    n_tags = run.model.od_tag_size
    sampler = BatchSampler(len(run.dataset), TRAIN_B, seed=args.seed)
    t0 = time.perf_counter()
    batches = [run.fetch(sampler.batch_at(s), sampler.epoch_at(s))
               for s in range(CLI_MEM_STEPS)]
    fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
    shapes = {k: v.shape for k, v in batches[0].items()}
    log(f"  visual_learning: {cfg.num_hidden_layers} layers, MRC over "
        f"{n_tags} tags; a batch fetched and masked on the main thread: "
        f"{fetch_ms:.1f} ms; shapes {shapes}")
    la = SS_LA + SS_T
    if (shapes["input_ids"] != (TRAIN_B, la)
            or shapes["attention_mask"] != (TRAIN_B, SS_L)
            or shapes["masked_region_targets"] != (TRAIN_B, SS_R, 2054)
            or tuple(shapes) != pre.SINGLE_STREAM_KEYS):
        raise AssertionError(f"visual_learning batch shapes {shapes}")
    text_share, region_share = region_checks(
        run, sampler.batch_at(0), sampler.epoch_at(0), batches[0], mt)

    # 1. in memory: 13 batches, 12 dropout launches a step, all at Lk 145
    bad_lengths = []
    with key_lengths(layers_mod) as seen:
        def before(trainer):
            seen.clear()

        def after(trainer, metrics):
            if seen != [SS_L] * per_step:
                bad_lengths.append(list(seen))
        with counted_steps(attn, per_step, "a visual_learning in-memory "
                           "step") as total, around_steps(before, after):
            torch.cuda.reset_peak_memory_stats()
            mem = train_on_batches(
                run.model, run.loss_fn, batches, CLI_MEM_STEPS,
                learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, seed=args.seed)
    if bad_lengths:
        raise AssertionError(f"in-memory key lengths {bad_lengths}")
    mem_n = cli_numbers(mem, TRAIN_B, torch.cuda.max_memory_allocated() / 1e9,
                        CLI_MEM_TIMED_FROM)
    mem_losses = check_losses(mem, CLI_MEM_STEPS, "visual_learning in memory")
    log(f"  visual_learning in memory: {total[0]} launches ({per_step} a "
        f"step, all at Lk {SS_L}); {mem_n['step_ms']:.2f} ms/step "
        f"{mem_n['samples_per_s']:.1f} samples/s, peak "
        f"{mem_n['peak_gb']:.2f} GB")
    run = None
    gc.collect()
    torch.cuda.empty_cache()

    # 2. one step at dropouts 0 on the first batch, kernel path against
    # plain path: fp32 held in full (phase 5's fp32 tolerances); bf16: each
    # gradient's relative distance from the fp32 plain path's at most 1.25
    # times the plain bf16 path's plus one bf16 ulp (2^-8), the losses
    # within phase 8's 0.02 of the plain path's
    batch = batch_on(DEVICE, batches[0])
    real, ref = {}, None
    for dn in ("float32", "bfloat16"):
        cfg0 = dataclasses.replace(cfg, dtype=dn, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
        model = ImgBertForPreTraining(cfg0, use_mrfr=True,
                                      od_tag_size=n_tags, device=DEVICE,
                                      seed=args.seed)
        model.train()

        def step():
            model.zero_grad(set_to_none=True)
            out = model(*(batch[k] for k in pre.SINGLE_STREAM_KEYS),
                        max_pred=max_pred)
            out["total_loss"].backward()
            params = dict(model.named_parameters())
            return (types.SimpleNamespace(**{k: v.detach()
                                             for k, v in out.items()}),
                    {n: params[n].grad.detach().float().clone()
                     for n in SS_GRAD_PARAMS})

        reset_counts(attn)
        k_out, k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0):
            raise AssertionError("kernel path did not launch the p = 0 "
                                 "kernel")
        with plain_attention_path(layers_mod, attn):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("plain path launched the kernel")
        what = "visual_learning real batch"
        if dn == "float32":
            compare_step(torch, what, dn, k_out, p_out, SS_LOSSES, k_grads,
                         p_grads)
            ref = (p_out, p_grads)
            real[dn] = {n: abs(getattr(k_out, n).item()
                               - getattr(p_out, n).item()) for n in SS_LOSSES}
        else:
            compare_step(torch, what, dn, k_out, p_out, SS_LOSSES, {}, {})

            def rel(a, c):
                return ((a - c).norm() / c.norm()).item()
            real[dn] = {}
            for n in SS_LOSSES:
                f = getattr(ref[0], n).item()
                log(f"  {what} {dn} {n}: from fp32 kernel "
                    f"{abs(getattr(k_out, n).item() - f):.3e}, plain "
                    f"{abs(getattr(p_out, n).item() - f):.3e} (printed)")
            for n in SS_GRAD_PARAMS:
                real[dn][n] = bf16_far(
                    f"{what} bfloat16 grad {n} (relative)",
                    rel(k_grads[n], ref[1][n]), rel(p_grads[n], ref[1][n]),
                    bool(k_grads[n].isfinite().all()), 2.0 ** -8,
                    "one bf16 ulp, relative")
        del model, k_out, p_out, k_grads, p_grads
        gc.collect()
        torch.cuda.empty_cache()
    del batch, batches, ref
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the CLI and its process loader
    out = os.path.join(root, "vl_train")
    argv = (["--output_dir", out, "--visual_learning", "--max_steps",
             str(CLI_STEPS), "--ckpt_period", str(CLI_STEPS)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.pretrain " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    bad_lengths = []
    with key_lengths(layers_mod) as seen:
        def before(trainer):
            seen.clear()

        def after(trainer, metrics):
            if seen != [SS_L] * per_step:
                bad_lengths.append(list(seen))
        with counted_steps(attn, per_step, "a visual_learning CLI step") \
                as total, around_steps(before, after):
            torch.cuda.reset_peak_memory_stats()
            hist = pre.main(argv)["train"]
    if bad_lengths:
        raise AssertionError(f"CLI key lengths {bad_lengths}")
    cli_n = cli_numbers(hist, TRAIN_B,
                        torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(hist, CLI_STEPS, "visual_learning CLI")
    names = ("mlm", "itm", "mrc", "mrf")
    for when, m in (("first", hist[0]), ("last", hist[-1])):
        log(f"  {when} step: " + " ".join(f"{k}={m[k]:.4f}" for k in names))
    if not mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"visual_learning CLI losses not falling: "
                             f"{losses}")
    log(f"  visual_learning step 1 loss: CLI {losses[0]:.6f}, in memory "
        f"{mem_losses[0]:.6f}")
    if abs(losses[0] - mem_losses[0]) > STEP_TOL["bfloat16"][0]:
        raise AssertionError("the visual_learning CLI's first batch is not "
                             "the sampler's")
    ratio = cli_n["samples_per_s"] / mem_n["samples_per_s"]
    log(f"  visual_learning CLI: {total[0]} launches ({per_step} a step, all "
        f"with dropout, all at Lk {SS_L}; plain 0); {cli_n['step_ms']:.2f} "
        f"ms/step {cli_n['samples_per_s']:.1f} samples/s, peak "
        f"{cli_n['peak_gb']:.2f} GB; main thread data "
        f"{cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch, H2D "
        f"{cli_n.get('h2d_ms', float('nan')):.3f} ms/batch; ratio to memory "
        f"{ratio:.3f} (target 0.90)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches_per_step=per_step, launches=total[0],
                in_memory=mem_n, cli=cli_n, ratio=ratio,
                main_fetch_ms=fetch_ms, text_mask_share=text_share,
                region_mask_share=region_share, real_batch=real,
                first_step={k: hist[0][k] for k in ("loss",) + names},
                last_step={k: hist[-1][k] for k in ("loss",) + names},
                losses=losses, mem_losses=mem_losses)


def phase11_extra(torch, attn, paths, root):
    """(c) `--extra_mode img_only`, then `text_only`: the sampler's first
    batch one step in memory, then SS_EXTRA_STEPS CLI steps, each launching
    the dropout kernel 48 times (24 main + 24 extra) and the plain attention
    never, finite extra losses, step 1's total equal to memory's."""
    import gc
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.training.loop import train_on_batches
    data = ["--corpus_tsv", paths["corpus"], "--feature_tsv",
            paths["features"], "--id2phrase", paths["id2phrase"],
            "--tag2id", paths["tag2id"]]
    tokenizer = FastBertTokenizer(paths["vocab"])
    res = {}
    for mode in ("img_only", "text_only"):
        common = (["--train_batch_size", str(TRAIN_B), "--log_period", "1",
                   "--num_workers", "4", "--worker_start_method", "fork",
                   "--data_dir", root, "--extra_mode", mode] + data
                  + PRE_ARGS + CLI_PLATFORM)
        args = pre.get_args(["--output_dir", root] + common)
        run = pre.prepare(args, tokenizer, DEVICE, _Log)
        per_step = 2 * run.model.config.half_layers * 4
        sampler = BatchSampler(len(run.dataset), TRAIN_B, seed=args.seed)
        first = run.fetch(sampler.batch_at(0), sampler.epoch_at(0))
        n_extra = first[pre.EXTRA_PREFIX + "input_ids_a"].shape[0]
        with counted_steps(attn, per_step, f"an {mode} in-memory step"):
            mem = train_on_batches(run.model, run.loss_fn, [first], 1,
                                   learning_rate=args.learning_rate,
                                   weight_decay=args.weight_decay,
                                   seed=args.seed)
        run = None
        gc.collect()
        torch.cuda.empty_cache()
        argv = (["--output_dir", os.path.join(root, f"extra_{mode}"),
                 "--max_steps", str(SS_EXTRA_STEPS), "--ckpt_period",
                 str(SS_EXTRA_STEPS)] + common)
        with counted_steps(attn, per_step, f"an {mode} CLI step") as total:
            hist = pre.main(argv)["train"]
        losses = check_losses(hist, SS_EXTRA_STEPS, f"{mode} CLI")
        extra = [m.get("extra", float("nan")) for m in hist]
        step_ms = mean([m["step_ms"] for m in hist[1:]])
        log(f"  --extra_mode {mode}: extra sub-batch {n_extra} of "
            f"{TRAIN_B}; {total[0]} launches ({per_step} a step: "
            f"{per_step // 2} main + {per_step // 2} extra, all with dropout, "
            f"plain 0); extra losses " + " ".join(f"{x:.4f}" for x in extra)
            + f"; step 1 total: CLI {losses[0]:.6f}, in memory "
            f"{mem[0]['loss']:.6f}; {step_ms:.2f} ms/step over steps "
            f"2-{SS_EXTRA_STEPS}")
        if (not all(map(math.isfinite, extra))
                or abs(losses[0] - mem[0]["loss"]) > STEP_TOL["bfloat16"][0]):
            raise AssertionError(f"--extra_mode {mode}: extra {extra}, step 1 "
                                 f"{losses[0]} vs {mem[0]['loss']}")
        res[mode] = dict(launches_per_step=per_step, launches=total[0],
                         extra_batch=n_extra, losses=losses,
                         extra_losses=extra, mem_loss=mem[0]["loss"],
                         step_ms=step_ms)
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase11_classifier(torch, attn, layers_mod, paths):
    """(d) `ImgBertForSequenceClassification` (3,129 labels, VQA's answer
    set) at B 64 on the first rows of a `--visual_learning` batch's inputs:
    one forward with a [B, L, L] seq2seq mask and one with a per-layer list
    (6 layers of a text / image block mask, then 6 of the padded key mask),
    each 12 p = 0 launches at Lk 145; kernel path against plain path: fp32
    logits within 1e-5, bf16 by phase 10's rule against the fp32 plain
    path."""
    import dataclasses
    import gc
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ImgBertForSequenceClassification
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.tasks.common import build_config
    from mvp_pytorch_tpu_torch.training.loop import batch_on
    args = pre.get_args(["--output_dir", "unused", "--visual_learning",
                         "--corpus_tsv", paths["corpus"], "--feature_tsv",
                         paths["features"], "--tag2id", paths["tag2id"]]
                        + PRE_ARGS + CLI_PLATFORM)
    tokenizer = FastBertTokenizer(paths["vocab"])
    cfg = build_config(args, tokenizer, num_labels=QA_ANSWERS,
                       loss_type="bce", hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    dataset = pre.build_dataset(args, tokenizer, cfg)
    batch = batch_on(DEVICE, pre.single_stream_batch(
        dataset.fetch(np.arange(SS_CLS_B), 0), args.max_tag_length))
    key_mask = batch["attention_mask"]
    layers = cfg.num_hidden_layers
    half = layers // 2
    masks = {"3-D": seq2seq_mask(torch, key_mask, SS_LA + SS_T),
             "per-layer": ([block_mask(torch, key_mask, SS_LA + SS_T)] * half
                           + [key_mask] * (layers - half))}
    inputs = (batch["input_ids"], batch["token_type_ids"], batch["img_feats"])
    refs, res = {}, {}
    for dn in ("float32", "bfloat16"):
        model = ImgBertForSequenceClassification(
            dataclasses.replace(cfg, dtype=dn), device=DEVICE, seed=args.seed)
        for name, mask in masks.items():
            def forward():
                with torch.no_grad():
                    return model(inputs[0], mask, *inputs[1:])
            reset_counts(attn)
            with key_lengths(layers_mod) as seen:
                k_logits = forward()
            torch.cuda.synchronize()
            got = (attn.masked_attention.launches,
                   attn.masked_attention.dropout_launches)
            if got != (layers, 0) or seen != [SS_L] * layers:
                raise AssertionError(f"classifier {name} {dn}: launches "
                                     f"{got}, key lengths {seen}")
            with plain_attention_path(layers_mod, attn):
                p_logits = forward()
            torch.cuda.synchronize()
            what = f"classifier B {SS_CLS_B} {name} mask {dn}"
            gap = max_dist(k_logits, p_logits)
            if dn == "float32":
                ok = bool(k_logits.isfinite().all()) and gap <= NLVR_FP32_TOL
                log(f"  {what} logits {tuple(k_logits.shape)}: "
                    f"max|kernel-plain| {gap:.3e} tol {NLVR_FP32_TOL:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(what)
                refs[name] = p_logits
                res[f"{name} {dn}"] = {"kernel_plain": gap}
            else:
                ref = refs[name]
                scale = ref.abs().max().item()
                res[f"{name} {dn}"] = bf16_far(
                    f"{what} logits", max_dist(k_logits, ref),
                    max_dist(p_logits, ref),
                    bool(k_logits.isfinite().all()), bf16_ulp(scale),
                    f"1 bf16 ulp at max|logit| {scale:.4f}")
            del k_logits, p_logits
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase11(torch, attn, layers_mod):
    """Phase 11 on phase 8's generated root: (a) the kernel at the
    single-stream length, (b) --visual_learning, (c) --extra_mode, (d) the
    classifier with 3-D and per-layer masks."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    res["kernel"] = phase11_kernel(torch, attn)
    res["kernel"]["seconds"] = time.perf_counter() - t0
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase11")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, corpus=True)
        log(f"  root: {CLI_IMAGES} images, {CLI_IMAGES * CLI_CAPS} corpus "
            f"rows, {CLI_REGIONS} regions x 2054 fp32 ({feat_bytes / 1e6:.1f}"
            f" MB of features, {tsv_bytes / 1e6:.1f} MB of TSV), 2,000 tags "
            f"written in {time.perf_counter() - t0:.1f} s")
        for part, fn in (
                ("visual_learning", lambda: phase11_visual_learning(
                    torch, attn, layers_mod, paths, root)),
                ("extra_mode", lambda: phase11_extra(torch, attn, paths,
                                                     root)),
                ("classifier", lambda: phase11_classifier(
                    torch, attn, layers_mod, paths))):
            t0 = time.perf_counter()
            res[part] = fn()
            seconds = time.perf_counter() - t0
            if isinstance(res[part], dict):
                res[part]["seconds"] = seconds
            log(f"  phase 11 {part} took {seconds:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {res['seconds']:.1f} s")
    return res


def single_stream_summary(p11):
    """Phase 11's numbers for the kernel line (without the per-step loss
    lists)."""
    vl = {k: v for k, v in p11["visual_learning"].items()
          if k not in ("losses", "mem_losses")}
    times = p11["kernel"]["times"]
    return {
        "launches_per_step": vl["launches_per_step"],
        "attention": {k: v for k, v in times.items()
                      if k.startswith("single") and not k.endswith("fp32")},
        "serving_attention": {k: v for k, v in times.items()
                              if not k.startswith("single")},
        "kernel_vs_plain": p11["kernel"]["errors"],
        "dropout_masks": p11["kernel"]["dropout_masks"],
        "visual_learning": vl, "extra_mode": p11["extra_mode"],
        "classifier": p11["classifier"], "seconds": p11["seconds"]}


# ---------------------------------------------------------------------------
# phase 12: captioning (CaptioningModel over ImgBertModel) on the card: the
# kernel at the captioning shapes, one training step kernel path against
# plain path, the captioning command line's training, greedy and beam
# decoding (history-cached and recompute) and its standalone eval
# ---------------------------------------------------------------------------

# caption 35, tags 20, regions 50: training at L 105 (COMMANDS.md:118-129,
# the JAX driver's defaults); --max_gen_length 20: the cached step runs
# [committed token, [MASK]] against the 20 caption slots, the 70 context
# keys and the 2 fresh ones (Lq 2 / Lk 92), the recompute forward at L 90
CAP_LEN, CAP_GEN = 35, 20
CAP_CTX = SS_T + SS_R
CAP_L = CAP_LEN + CAP_CTX
CAP_DEC_L = CAP_GEN + CAP_CTX
CAP_B, CAP_IMAGES, CAP_BEAMS = 64, 250, 5
CAP_DROP_AFTER = 13                  # the drop-worst gate opens at CLI step 14
CAP_ARGS = ["--max_seq_length", str(CAP_LEN), "--max_tag_length", str(SS_T),
            "--max_img_seq_length", str(SS_R), "--max_gen_length",
            str(CAP_GEN), "--label_smoothing", "0.1", "--drop_worst_ratio",
            "0.2", "--drop_worst_after", str(CAP_DROP_AFTER),
            "--learning_rate", "3e-5", "--dtype", "bfloat16", "--seed", "11"]
CAP_GRAD_PARAMS = ("bert.embeddings.word_embeddings.weight",
                   "cls.predictions.bias",
                   "cls.predictions.transform.dense.weight",
                   "bert.img_embedding.weight",
                   "bert.encoder.layer.0.attention.self.query.weight")
# fp32 decoding: the cached step's logits against the recompute forward's on
# the same committed prefix
CAP_DECODE_TOL = 1e-4
# the kernel's captioning shapes: (name, N, Lq, Lk, mask, dropout rates,
# grads checked): training (B 64, seq2seq bias), the cached step at the
# greedy and the beam batch and its one-query form (per-query bias), the
# recompute forward (seq2seq bias over the 20-slot buffer)
CAP_SHAPES = (
    ("train", CAP_B, CAP_L, CAP_L, "seq2seq", (0.0, DROP_P), True),
    ("step", CAP_IMAGES, 2, CAP_DEC_L + 2, "step", (0.0,), False),
    ("step", CAP_IMAGES * CAP_BEAMS, 2, CAP_DEC_L + 2, "step", (0.0,), False),
    ("step", CAP_IMAGES, 1, CAP_DEC_L + 1, "step", (0.0,), False),
    ("recompute", CAP_IMAGES, CAP_DEC_L, CAP_DEC_L, "recompute", (0.0,),
     False))


def caption_bias(torch, attn, gen, kind, n, lq):
    """The additive bias of a captioning attention shape over contexts whose
    tags and regions are padded to random lengths: the seq2seq mask of
    training (35 caption slots) or of the recompute forward (20), or the
    decode step's per-query mask at a random position t per row (caption
    slots before t - 1, the context, and the lq fresh keys at or before
    each query)."""
    from mvp_pytorch_tpu_torch.models.img_bert import make_seq2seq_mask
    parts = []
    for length, low in ((SS_T, 3), (SS_R, 10)):
        lens = torch.randint(low, length + 1, (n,), device=DEVICE,
                             generator=gen)
        parts.append(torch.arange(length, device=DEVICE)[None]
                     < lens[:, None])
    ctx = torch.cat(parts, 1)
    if kind != "step":
        l_cap = CAP_LEN if kind == "seq2seq" else CAP_GEN
        return attn.mask_to_bias(make_seq2seq_mask(l_cap, ctx))
    t = torch.randint(1, CAP_GEN, (n,), device=DEVICE, generator=gen)
    cap = torch.arange(CAP_GEN, device=DEVICE)[None] < (t[:, None] - 1)
    fresh = torch.ones(lq, lq, dtype=torch.bool, device=DEVICE).tril()
    mask = torch.cat([cap[:, None].expand(n, lq, CAP_GEN),
                      ctx[:, None].expand(n, lq, CAP_CTX),
                      fresh[None].expand(n, lq, lq)], 2)
    return attn.mask_to_bias(mask.to(torch.int32))


def phase12_kernel(torch, attn):
    """(a) The kernel at the captioning shapes (blhd, as the model calls
    it), in both dtypes, against the plain version (fp32 2e-5, bf16 0.05);
    at L 105 at p 0 and 0.1 with its grads against fp32 autograd of the
    plain version (1e-4 / 0.05). Timed beside the plain version, SDPA (a
    yardstick the port never calls) and the bound: in bf16 at p 0, and at
    L 105 also at p 0.1 and in fp32."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errors, times = {}, {}
    for name, n, lq, lk, kind, rates, grads in CAP_SHAPES:
        for dn, dt in dtypes.items():
            q = torch.randn(n, lq, H, D, device=DEVICE, generator=gen).to(dt)
            k, v = (torch.randn(n, lk, H, D, device=DEVICE, generator=gen)
                    .to(dt) for _ in range(2))
            bias = caption_bias(torch, attn, gen, kind, n, lq)
            for p in rates:
                seed = (torch.randint(-2 ** 63, 2 ** 63 - 1, (1,),
                                      dtype=torch.int64, device=DEVICE,
                                      generator=gen) if p else None)
                leaves = [t.detach().requires_grad_(grads) for t in (q, k, v)]
                before = (attn.masked_attention.launches,
                          attn.masked_attention.dropout_launches)
                out = attn.masked_attention(*leaves, bias, layout="blhd",
                                            dropout_p=p, seed=seed)
                launched = (attn.masked_attention.launches - before[0],
                            attn.masked_attention.dropout_launches - before[1])
                want = attn.plain_attention_blhd(q, k, v, bias, p, seed)
                f_err = (out.float() - want.float()).abs().max().item()
                finite = bool(torch.isfinite(out.float()).all())
                b_err = 0.0
                if grads:
                    g = torch.randn(out.shape, device=DEVICE,
                                    generator=gen).to(dt)
                    got_g = torch.autograd.grad(out, leaves, g)
                    ref = [t.detach().float().requires_grad_() for t in leaves]
                    want_g = torch.autograd.grad(
                        attn.plain_attention_blhd(*ref, bias, p, seed), ref,
                        g.float())
                    b_err = max((a.float() - c).abs().max().item()
                                for a, c in zip(got_g, want_g))
                    finite = finite and all(bool(torch.isfinite(a).all())
                                            for a in got_g)
                torch.cuda.synchronize()
                key = f"{name} N {n} Lq {lq} Lk {lk} p {p:g}"
                ok = (finite and f_err <= TOL[dn] and b_err <= GRAD_TOL[dn]
                      and launched == (1, int(p > 0)))
                log(f"  kernel vs plain  {key} {dn}: fwd max|err|="
                    f"{f_err:.3e} (tol {TOL[dn]:g})"
                    + (f"  grads max|err|={b_err:.3e} (tol {GRAD_TOL[dn]:g})"
                       if grads else "")
                    + f"  launches {launched}  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"kernel at the captioning shape {key} {dn} "
                        f"disagrees: fwd {f_err} grads {b_err} finite "
                        f"{finite} launches {launched}")
                errors[f"{key} {dn}"] = dict(fwd=f_err, grads=b_err)
                if dn == "float32" and not (name == "train" and p == 0):
                    continue
                x = [t.detach() for t in (q, k, v)]
                xh = [t.transpose(1, 2) for t in x]
                bound, by = attention_bound_ms(n, lq, lk, dn, bias)
                row = dict(
                    max_abs_err=f_err, bound_ms=bound, bound_by=by,
                    ms=cuda_ms(lambda: attn.masked_attention(
                        *x, bias, layout="blhd", dropout_p=p, seed=seed)),
                    plain_ms=cuda_ms(lambda: attn.plain_attention_blhd(
                        *x, bias, p, seed), iters=5),
                    sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        *xh, attn_mask=bias.to(dt), dropout_p=p)))
                times[key + (" fp32" if dn == "float32" else "")] = row
                log(f"  kernel {key} {dn}: kernel {row['ms']:.4f} ms  plain "
                    f"{row['plain_ms']:.4f} ms  sdpa {row['sdpa_ms']:.4f} ms"
                    f"  bound {bound:.4f} ms ({by})")
                del leaves, out, want
            del q, k, v, bias
    torch.cuda.empty_cache()
    return dict(errors=errors, times=times)


def phase12_real_step(torch, attn, layers_mod, cfg, batch):
    """(b) One dropout-0 step on the first real batch (the CLI's first step:
    the drop-worst gate closed), kernel path against plain path: fp32, the
    loss within 1e-4 and five named gradients within 1e-3 relative; bf16,
    the loss within 0.02 and each gradient's relative distance from the
    fp32 plain path's at most 1.25 times the plain bf16 path's plus one
    bf16 ulp."""
    import dataclasses
    import gc
    import types
    from mvp_pytorch_tpu_torch.models import CaptioningModel
    from mvp_pytorch_tpu_torch.tasks.captioning import model_inputs
    per_step = cfg.num_hidden_layers
    real, ref = {}, None
    for dn in ("float32", "bfloat16"):
        cfg0 = dataclasses.replace(cfg, dtype=dn, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
        model = CaptioningModel(cfg0, label_smoothing=0.1,
                                drop_worst_ratio=0.2,
                                drop_worst_after=CAP_DROP_AFTER,
                                device=DEVICE, seed=11)
        model.train()

        def step():
            model.zero_grad(set_to_none=True)
            loss, _ = model(*model_inputs(batch), batch["masked_pos"],
                            batch["masked_ids"], 0)
            loss.backward()
            params = dict(model.named_parameters())
            return (types.SimpleNamespace(loss=loss.detach()),
                    {n: params[n].grad.detach().float().clone()
                     for n in CAP_GRAD_PARAMS})

        reset_counts(attn)
        with key_lengths(layers_mod) as seen:
            k_out, k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0
                or seen != [CAP_L] * per_step):
            raise AssertionError(f"captioning step: kernel path launches "
                                 f"{attn.masked_attention.launches}, key "
                                 f"lengths {seen}")
        with plain_attention_path(layers_mod, attn):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("plain path launched the kernel")
        what = "captioning real batch"
        if dn == "float32":
            compare_step(torch, what, dn, k_out, p_out, ("loss",), k_grads,
                         p_grads)
            ref = (p_out, p_grads)
            real[dn] = {"loss": abs(k_out.loss.item() - p_out.loss.item())}
            real[dn].update({n: ((k_grads[n] - p_grads[n]).norm()
                                 / p_grads[n].norm()).item()
                             for n in CAP_GRAD_PARAMS})
        else:
            compare_step(torch, what, dn, k_out, p_out, ("loss",), {}, {})

            def rel(a, c):
                return ((a - c).norm() / c.norm()).item()
            real[dn] = {"loss": abs(k_out.loss.item() - p_out.loss.item())}
            for n in CAP_GRAD_PARAMS:
                real[dn][n] = bf16_far(
                    f"{what} bfloat16 grad {n} (relative)",
                    rel(k_grads[n], ref[1][n]), rel(p_grads[n], ref[1][n]),
                    bool(k_grads[n].isfinite().all()), 2.0 ** -8,
                    "one bf16 ulp, relative")
        del model, k_out, p_out, k_grads, p_grads
        gc.collect()
        torch.cuda.empty_cache()
    return real


def phase12_cli(torch, attn, layers_mod, paths, root):
    """(b) and (c): the first real batch's step kernel path against plain
    path; 13 batches in memory, then 26 steps through the captioning CLI
    and its process loader (4 forked workers), each launching the dropout
    kernel 12 times, all at Lk 105, and the plain attention never. Returns
    the numbers and the CLI's checkpoint."""
    import gc
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.tasks import captioning as cap
    from mvp_pytorch_tpu_torch.training.loop import batch_on, train_on_batches
    common = (["--captions_json", paths["captions"], "--feature_tsv",
               paths["features"], "--data_dir", root, "--train_batch_size",
               str(CAP_B), "--log_period", "1", "--num_workers", "4",
               "--worker_start_method", "fork"] + CAP_ARGS + CLI_PLATFORM)
    args = cap.get_args(["--output_dir", root] + common)
    dataset, model = cap.prepare(args, FastBertTokenizer(paths["vocab"]),
                                 DEVICE, _Log)
    cfg = model.config
    per_step = cfg.num_hidden_layers
    sampler = BatchSampler(len(dataset), CAP_B, seed=args.seed)
    t0 = time.perf_counter()
    batches = [dataset.fetch(sampler.batch_at(s))
               for s in range(CLI_MEM_STEPS)]
    fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
    shapes = {k: v.shape for k, v in batches[0].items()}
    masked = float(batches[0]["masked_pos"].sum()) / CAP_B
    log(f"  captioning: {per_step} layers over L {CAP_L}, the LM head over "
        f"all {cfg.vocab_size} rows; a batch fetched on the main thread: "
        f"{fetch_ms:.1f} ms; shapes {shapes}; {masked:.2f} masked caption "
        f"positions a row")
    if (shapes["caption_ids"] != (CAP_B, CAP_LEN)
            or shapes["ctx_mask"] != (CAP_B, CAP_CTX)
            or shapes["img_feat"] != (CAP_B, SS_R, 2054)):
        raise AssertionError(f"captioning batch shapes {shapes}")

    @contextlib.contextmanager
    def length_check(bad):
        """Every step inside runs its attention at Lk CAP_L only."""
        with key_lengths(layers_mod) as seen:
            def before(trainer):
                seen.clear()

            def after(trainer, metrics):
                if seen != [CAP_L] * per_step:
                    bad.append(list(seen))
            with around_steps(before, after):
                yield

    # 1. in memory: 13 batches, 12 dropout launches a step, all at Lk 105
    bad = []
    with counted_steps(attn, per_step, "a captioning in-memory step") \
            as total, length_check(bad):
        torch.cuda.reset_peak_memory_stats()
        mem = train_on_batches(model, cap.caption_loss_fn, batches,
                               CLI_MEM_STEPS, learning_rate=args.learning_rate,
                               weight_decay=args.weight_decay, seed=args.seed)
    if bad:
        raise AssertionError(f"in-memory key lengths {bad}")
    mem_n = cli_numbers(mem, CAP_B, torch.cuda.max_memory_allocated() / 1e9,
                        CLI_MEM_TIMED_FROM)
    mem_losses = check_losses(mem, CLI_MEM_STEPS, "captioning in memory")
    log(f"  captioning in memory: {total[0]} launches ({per_step} a step, "
        f"all at Lk {CAP_L}); {mem_n['step_ms']:.2f} ms/step "
        f"{mem_n['samples_per_s']:.1f} samples/s, peak "
        f"{mem_n['peak_gb']:.2f} GB")
    model = None
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the first batch's step, kernel path against plain path
    real = phase12_real_step(torch, attn, layers_mod, cfg,
                             batch_on(DEVICE, batches[0]))
    del batches
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the CLI and its process loader
    out = os.path.join(root, "cap_train")
    argv = (["--output_dir", out, "--do_train", "--max_steps",
             str(CLI_STEPS), "--ckpt_period", str(CLI_STEPS)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.captioning " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    bad = []
    with counted_steps(attn, per_step, "a captioning CLI step") as total, \
            length_check(bad):
        torch.cuda.reset_peak_memory_stats()
        hist = cap.main(argv)["train"]
    if bad:
        raise AssertionError(f"CLI key lengths {bad}")
    cli_n = cli_numbers(hist, CAP_B, torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(hist, CLI_STEPS, "captioning CLI")
    if not mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"captioning CLI losses not falling: {losses}")
    log(f"  captioning step 1 loss: CLI {losses[0]:.6f}, in memory "
        f"{mem_losses[0]:.6f} (the drop-worst gate opens at step "
        f"{CAP_DROP_AFTER + 1})")
    if abs(losses[0] - mem_losses[0]) > STEP_TOL["bfloat16"][0]:
        raise AssertionError("the captioning CLI's first batch is not the "
                             "sampler's")
    ratio = cli_n["samples_per_s"] / mem_n["samples_per_s"]
    log(f"  captioning CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, all at Lk {CAP_L}; plain 0); {cli_n['step_ms']:.2f} "
        f"ms/step {cli_n['samples_per_s']:.1f} samples/s, peak "
        f"{cli_n['peak_gb']:.2f} GB; main thread data "
        f"{cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch, H2D "
        f"{cli_n.get('h2d_ms', float('nan')):.3f} ms/batch; ratio to memory "
        f"{ratio:.3f} (target 0.90)")
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(launches_per_step=per_step, launches=total[0],
               in_memory=mem_n, cli=cli_n, ratio=ratio,
               main_fetch_ms=fetch_ms, real_batch=real, losses=losses,
               mem_losses=mem_losses)
    return res, os.path.join(out, f"checkpoint-{CLI_STEPS:07d}"), dataset


def decode_launches(layers, mode):
    """(launches, key lengths) of one decode of CAP_GEN positions by a
    model of `layers` layers: the cached path's prefill over the context
    (L 70), then one step per position at Lk 92; the recompute path's
    forward at L 90 per position. Beam search makes the same calls on
    B x beams rows."""
    steps = CAP_GEN - 1
    if mode == "cached":
        lengths = [CAP_CTX] * layers + [CAP_DEC_L + 2] * (layers * steps)
    else:
        lengths = [CAP_DEC_L] * (layers * steps)
    return len(lengths), lengths


def device_profile(torch, fn) -> dict:
    """The card's work during one call of `fn` under `torch.profiler` (whose
    host overhead stretches the window, not the kernels): the busy seconds
    (the union of the device events' intervals), the device ms by
    `profile_two_stage` kernel class and the five kernels with the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from profile_two_stage import busy_us, classify
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device events")
    by_class, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_class[classify(e.name)] = by_class.get(classify(e.name), 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    return dict(busy_s=busy_us([(e.time_range.start, e.time_range.end)
                                for e in kernels]) / 1e6,
                ms_by_class=dict(sorted(by_class.items(),
                                        key=lambda kv: -kv[1])),
                top_kernels_ms=dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:5]))


def phase12_decode(torch, attn, layers_mod, ckpt, dataset, tokenizer):
    """(d) Greedy and beam-5 decoding of CAP_IMAGES images with the CLI's
    checkpoint, each history-cached and recomputed, in bf16: 240 launches
    (cached) or 228 (recompute) each, all at p 0, the plain attention never;
    captions/s, ms per step and the cached over recompute speed-up. In fp32:
    the cached path's greedy sequence teacher-forced through both paths,
    whose logits agree within CAP_DECODE_TOL at every step; the greedy
    sequences equal except where the top-2 logit gap at the first
    difference is below that tolerance (such rows are counted). bf16 rows
    that differ between the paths are counted, not failed. Each decode is
    timed after a warm-up at its size, and profiled once more for the
    card's busy time."""
    import gc
    from mvp_pytorch_tpu_torch.models import CaptioningModel, ModelConfig
    from mvp_pytorch_tpu_torch.tasks.captioning import (context_batch,
                                                         decode_batch)
    imgs = dataset.images()[:CAP_IMAGES]
    ids_b, ctx_mask, feats = context_batch(dataset, imgs, DEVICE)
    vocab = tokenizer.vocab
    n = len(imgs)
    model = load_checkpoint(torch, CaptioningModel, ckpt)
    layers = model.config.num_hidden_layers
    seqs, res = {}, {}
    for beams in (1, CAP_BEAMS):
        for mode in ("cached", "recompute"):
            def run(m=n):
                return decode_batch(model, ids_b[:m], ctx_mask[:m],
                                    feats[:m], vocab, gen_len=CAP_GEN,
                                    num_beams=beams, decode_mode=mode)
            run()                                  # warm-up, not counted
            reset_counts(attn)
            with key_lengths(layers_mod) as seen:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run().cpu()
                seconds = time.perf_counter() - t0
            want, lengths = decode_launches(layers, mode)
            got = (attn.masked_attention.launches,
                   attn.masked_attention.dropout_launches,
                   attn.plain_attention.calls)
            what = f"{'greedy' if beams == 1 else f'beam-{beams}'} {mode}"
            if got != (want, 0, 0) or seen != lengths:
                raise AssertionError(
                    f"{what} decode: launches {got} (want {want}, 0, 0), "
                    f"key lengths {sorted(set(seen))}")
            seqs[(beams, mode)] = out
            prof = device_profile(torch, run)
            busy = prof["busy_s"]
            res[what] = dict(launches=want, seconds=seconds,
                             captions_per_s=n / seconds,
                             ms_per_step=seconds * 1e3 / (CAP_GEN - 1),
                             rows=n * beams, device_busy_s=busy,
                             idle_share=1.0 - busy / seconds,
                             device_ms_by_class=prof["ms_by_class"],
                             top_kernels_ms=prof["top_kernels_ms"])
            log(f"  decode {what}: {n} images ({n * beams} rows), {want} "
                f"launches at Lk {sorted(set(lengths))}, p 0, plain 0; "
                f"{seconds:.3f} s, {n / seconds:.1f} captions/s, "
                f"{seconds * 1e3 / (CAP_GEN - 1):.2f} ms/step; device busy "
                f"{busy:.3f} s of it (a profiled run), idle share "
                f"{1.0 - busy / seconds:.3f}; device ms by class "
                + ", ".join(f"{k} {v:.1f}"
                            for k, v in prof["ms_by_class"].items())
                + "; top kernels " + "; ".join(
                    f"{k} {v:.1f}" for k, v in prof["top_kernels_ms"].items()))
    for beams in (1, CAP_BEAMS):
        what = "greedy" if beams == 1 else f"beam-{beams}"
        c, r = seqs[(beams, "cached")], seqs[(beams, "recompute")]
        speed = (res[f"{what} recompute"]["seconds"]
                 / res[f"{what} cached"]["seconds"])
        differ = int((c != r).any(1).sum())
        res[f"{what} bf16"] = dict(speedup=speed, rows_differ=differ)
        log(f"  {what} bf16: cached over recompute {speed:.2f}x; {differ} of "
            f"{n} rows differ between the paths (printed, not held)")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32: the cached path's sequence teacher-forced through both paths
    model = CaptioningModel(ModelConfig.from_pretrained(ckpt,
                                                        dtype="float32"),
                            device=DEVICE)
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     map_location=DEVICE, weights_only=True))
    greedy = {mode: decode_batch(model, ids_b, ctx_mask, feats, vocab,
                                 gen_len=CAP_GEN, num_beams=1,
                                 decode_mode=mode)
              for mode in ("cached", "recompute")}
    seq = greedy["cached"]
    mask_id = vocab["[MASK]"]
    seg, cap_seg = torch.ones_like(ids_b), torch.zeros(
        n, CAP_GEN, dtype=ids_b.dtype, device=DEVICE)
    err, gaps = 0.0, []
    with torch.no_grad():
        cache = model.prefill(ids_b, ctx_mask, seg, feats, CAP_GEN)
        buf = torch.full_like(seq, mask_id)
        buf[:, 0] = seq[:, 0]
        for t in range(1, CAP_GEN):
            lc, cache = model.decode_step(cache, t, seq[:, t - 1], ctx_mask,
                                          CAP_GEN, mask_id)
            buf[:, t - 1] = seq[:, t - 1]
            lr = model.decode_logits(buf, ids_b, ctx_mask, cap_seg, seg,
                                     feats, t)
            err = max(err, (lc - lr).abs().max().item())
            top2 = lc.topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu())
    gaps = torch.stack(gaps, 1)                      # [n, CAP_GEN - 1]
    diff = (greedy["cached"] != greedy["recompute"]).cpu()
    near_ties, far = 0, []
    for row in torch.nonzero(diff.any(1)).flatten().tolist():
        t = int(torch.nonzero(diff[row]).flatten()[0])
        if gaps[row, t - 1] < CAP_DECODE_TOL:
            near_ties += 1
        else:
            far.append((row, t, gaps[row, t - 1].item()))
    ok = err <= CAP_DECODE_TOL and not far
    log(f"  fp32 decode: the cached greedy sequence teacher-forced through "
        f"both paths, max |cached - recompute| logit {err:.3e} (tol "
        f"{CAP_DECODE_TOL:g}); greedy rows that differ "
        f"{int(diff.any(1).sum())} of {n}, {near_ties} at a top-2 gap below "
        f"the tolerance  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fp32 cached decoding is not the recompute's: "
                             f"logit gap {err}, rows {far[:5]}")
    res["fp32"] = dict(logit_err=err, rows_differ=int(diff.any(1).sum()),
                       near_ties=near_ties)
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return res, imgs, seqs[(CAP_BEAMS, "cached")]


def phase12_eval(torch, attn, paths, root, ckpt, dataset, tokenizer, imgs,
                 beam_seqs):
    """(e) `--do_eval` alone on the CLI's checkpoint over (d)'s images
    (their captions.json), beam 5, cached, in one batch of CAP_IMAGES: 240
    launches, finite BLEU-4, METEOR, ROUGE_L and CIDEr-D in test_eval.json,
    SPICE absent without its jar, and the captions equal (d)'s."""
    import shutil
    from mvp_pytorch_tpu_torch.models import ModelConfig
    from mvp_pytorch_tpu_torch.tasks import captioning as cap
    from mvp_pytorch_tpu_torch.utils.spice import find_spice_jar
    shutil.copy(paths["vocab"], ckpt)
    with open(paths["captions"]) as f:
        caps = json.load(f)
    sub = os.path.join(root, "captions_eval.json")
    with open(sub, "w") as f:
        json.dump({img: caps[img] for img in imgs}, f)
    out = os.path.join(root, "cap_eval")
    argv = (["--output_dir", out, "--model_name_or_path", ckpt,
             "--captions_json", sub, "--feature_tsv", paths["features"],
             "--do_eval", "--num_beams", str(CAP_BEAMS), "--decode_mode",
             "cached", "--eval_batch_size", str(CAP_IMAGES)] + CLI_PLATFORM)
    log("  python -m mvp_pytorch_tpu_torch.tasks.captioning " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    reset_counts(attn)
    t0 = time.perf_counter()
    res = cap.main(argv)
    seconds = time.perf_counter() - t0
    want_launches = decode_launches(
        ModelConfig.from_pretrained(ckpt).num_hidden_layers, "cached")[0]
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    with open(os.path.join(out, "test_eval.json")) as f:
        scores = json.load(f)
    want = {img: cap.caption_tokens(row.tolist(), tokenizer)
            for img, row in zip(imgs, beam_seqs)}
    same = res["captions"] == want
    finite = all(math.isfinite(scores.get(k, float("nan")))
                 for k in ("Bleu_4", "METEOR", "ROUGE_L", "cider_d"))
    spice_ok = ("SPICE" in scores) == (find_spice_jar() is not None)
    ok = (got == (want_launches, 0, 0) and same and finite and spice_ok)
    log(f"  captioning eval: {seconds:.1f} s; launches {got} (want "
        f"{want_launches}, 0, 0); test_eval.json "
        + " ".join(f"{k}={v:.4f}" for k, v in scores.items())
        + f"; SPICE {'reported' if 'SPICE' in scores else 'absent'}; "
        f"captions equal the in-memory beam-{CAP_BEAMS} cached decode: "
        f"{same}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the captioning CLI's eval is off")
    return dict(seconds=seconds, launches=got[0], scores=scores)


def phase12(torch, attn, layers_mod):
    """Phase 12 on phase 7's generated root: (a) the kernel at the
    captioning shapes, (b) one step kernel path against plain path, (c) the
    CLI's training, (d) decoding, (e) the CLI's standalone eval."""
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    res["kernel"] = phase12_kernel(torch, attn)
    res["kernel"]["seconds"] = time.perf_counter() - t0
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase12")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root)
        log(f"  root: {CLI_IMAGES} images x {CLI_CAPS} captions, "
            f"{CLI_REGIONS} regions x 2054 fp32 ({feat_bytes / 1e6:.1f} MB "
            f"of features, {tsv_bytes / 1e6:.1f} MB of TSV) written in "
            f"{time.perf_counter() - t0:.1f} s")
        tokenizer = FastBertTokenizer(paths["vocab"])
        t0 = time.perf_counter()
        res["train"], ckpt, dataset = phase12_cli(torch, attn, layers_mod,
                                                  paths, root)
        res["train"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 12 training took {res['train']['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["decode"], imgs, beam_seqs = phase12_decode(
            torch, attn, layers_mod, ckpt, dataset, tokenizer)
        res["decode"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 12 decoding took {res['decode']['seconds']:.1f} s")
        res["eval"] = phase12_eval(torch, attn, paths, root, ckpt, dataset,
                                   tokenizer, imgs, beam_seqs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {res['seconds']:.1f} s")
    return res


def captioning_summary(p12):
    """Phase 12's numbers for the kernel line (without the per-step loss
    lists)."""
    times = p12["kernel"]["times"]
    return {
        "launches_per_step": p12["train"]["launches_per_step"],
        "attention": {k: v for k, v in times.items()
                      if not k.endswith("fp32")},
        "kernel_vs_plain": p12["kernel"]["errors"],
        "train": {k: v for k, v in p12["train"].items()
                  if k not in ("losses", "mem_losses")},
        "first_loss": p12["train"]["losses"][0],
        "last_loss": p12["train"]["losses"][-1],
        "decode": p12["decode"], "eval": p12["eval"],
        "seconds": p12["seconds"]}


# ---------------------------------------------------------------------------
# phase 13: from image to constrained caption on the card: the detector at
# full width, its training on synthetic boxes, feature extraction into the
# captioning command line with SCST and constrained beam search, CBS and
# SCST timed, and the kernel at their shapes
# ---------------------------------------------------------------------------

DET_CONFIG = {}                      # DetectorConfig() (a rehearsal shrinks it)
DET_BATCHES = (8, 32)                # the extraction tool's --batch_size, and 32
DET_CHECK_IMAGES = 2                 # images held card against CPU
DET_TOL = 1e-4
DET_ITERS = 10
DET_TRAIN_STEPS, DET_MAP_FLOOR, DET_MAP_IMAGES = 200, 0.4, 32
DET_CLI_FALL, DET_CLI_TAIL = 0.7, 10
P13_IMAGES, P13_CAPS, P13_CANVAS = 64, 5, 256   # train_cli's default canvas
P13_STEPS, P13_SCST_STEPS, P13_B = 13, 4, 32
SCST_B, SCST_TIMED = 8, 3
CBS_IMAGES, CBS_BEAMS, CBS_STATES = 16, 3, 8     # 2 two-token constraints
CBS_TOL = 1e-4
P13_TIMED = (("cbs", CBS_IMAGES * CBS_STATES * CBS_BEAMS, False),
             ("scst", SCST_B * CAP_GEN, True))


def device_kernels(torch, fn) -> int:
    """The number of device kernels that one call of `fn` launches (from
    `torch.profiler`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def rel_max(a, ref) -> float:
    return max_dist(a, ref) / max(ref.float().abs().max().item(), 1e-12)


def det_images(n, canvas, seed):
    """n synthetic detection images [n, canvas, canvas, 3] in [-1, 1] (the
    coloured boxes of `synthetic_boxes.make_batch`)."""
    from mvp_pytorch_tpu_torch.detection.synthetic_boxes import make_batch
    return make_batch(np.random.RandomState(seed), n, canvas)["images"]


def phase13_detector_check(torch, model, imgs):
    """fp32 on the card against the CPU run of the same module and weights
    on DET_CHECK_IMAGES images: the proposal field within DET_TOL of its
    largest magnitude; NMS on the card over the CPU's field, the same
    indices; the RoI head on the card over the CPU's boxes within DET_TOL
    relative; the card's own selection: the boxes that agree, their
    features within DET_TOL relative and class ids equal but at near ties.
    bf16 by the 1.25 rule: the card's bf16 field no further from the CPU's
    fp32 field than 1.25 times the CPU's bf16 field plus one bf16 ulp."""
    import dataclasses
    from mvp_pytorch_tpu_torch.detection import Detector, batched_nms
    cfg = model.config
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu = Detector(cfg, device="cpu")
    cpu.load_state_dict(state)
    x = torch.from_numpy(imgs[:DET_CHECK_IMAGES])
    xg = x.to(DEVICE)
    out = {}
    with torch.no_grad():
        c_obj, c_boxes, c_fmap = cpu.proposal_field(x)
        c_top = cpu.top_proposals(c_obj, c_boxes)
        c_idx, c_valid = batched_nms(*c_top, cfg.max_regions, cfg.nms_iou,
                                     cfg.score_threshold)
        c_sel = cpu.select(*c_top)
        c_feats, c_logits = cpu.roi_head(cpu.pool(c_fmap, c_sel[0]))
        g_obj, g_boxes, g_fmap = model.proposal_field(xg)
        g_idx, g_valid = batched_nms(*(t.to(DEVICE) for t in c_top),
                                     cfg.max_regions, cfg.nms_iou,
                                     cfg.score_threshold)
        g_on_c = model.roi_head(model.pool(g_fmap, c_sel[0].to(DEVICE)))
        g_out = model(xg)
    out["field_obj"] = rel_max(g_obj.cpu(), c_obj)
    out["field_boxes"] = rel_max(g_boxes.cpu(), c_boxes)
    out["nms_equal"] = bool(torch.equal(g_idx.cpu(), c_idx)
                            and torch.equal(g_valid.cpu(), c_valid))
    out["feats_on_cpu_boxes"] = rel_max(g_on_c[0].cpu(), c_feats)
    out["logits_on_cpu_boxes"] = rel_max(g_on_c[1].cpu(), c_logits)
    agree = (c_sel[2] & g_out.valid.cpu()
             & ((g_out.boxes.cpu() - c_sel[0]).abs().amax(-1)
                <= DET_TOL * cfg.canvas))
    out["boxes_agree"] = int(agree.sum())
    out["valid_cpu"] = int(c_sel[2].sum())
    feats_err = (rel_max(g_out.feats.cpu()[agree], c_feats[agree])
                 if agree.any() else 0.0)
    out["feats_where_boxes_agree"] = feats_err
    top2 = c_logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = agree & (g_out.class_ids.cpu() != c_logits.argmax(-1))
    near = differ & (gap < DET_TOL * c_logits.abs().max())
    out["class_ids_differ"] = int(differ.sum())
    out["class_ids_near_ties"] = int(near.sum())
    ok = (out["field_obj"] <= DET_TOL and out["field_boxes"] <= DET_TOL
          and out["nms_equal"] and out["feats_on_cpu_boxes"] <= DET_TOL
          and out["logits_on_cpu_boxes"] <= DET_TOL
          and feats_err <= DET_TOL and int(differ.sum()) == int(near.sum())
          and out["boxes_agree"] > 0)
    log(f"  detector fp32 card vs CPU ({DET_CHECK_IMAGES} images): field "
        f"objectness {out['field_obj']:.3e}, boxes {out['field_boxes']:.3e} "
        f"of their largest (tol {DET_TOL:g}); NMS over the CPU's field "
        f"{'equal' if out['nms_equal'] else 'DIFFERENT'}; RoI head over the "
        f"CPU's boxes: features {out['feats_on_cpu_boxes']:.3e}, logits "
        f"{out['logits_on_cpu_boxes']:.3e}; the card's own selection: "
        f"{out['boxes_agree']} of {out['valid_cpu']} boxes agree, features "
        f"there {feats_err:.3e}, class ids differ {out['class_ids_differ']} "
        f"({out['class_ids_near_ties']} at near ties)  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"detector fp32 card vs CPU: {out}")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    cpu16 = Detector(cfg16, device="cpu")
    cpu16.load_state_dict(state)
    g16 = Detector(cfg16, device=DEVICE)
    g16.load_state_dict(state)
    with torch.no_grad():
        p_obj, p_boxes, _ = cpu16.proposal_field(x)
        k_obj, k_boxes, _ = g16.proposal_field(xg)
    ulp = 2.0 ** -8
    out["bf16"] = {
        "objectness": bf16_far(
            "detector bf16 field objectness (card vs CPU bf16, from CPU "
            "fp32)", max_dist(k_obj.cpu(), c_obj), max_dist(p_obj, c_obj),
            bool(torch.isfinite(k_obj).all()), ulp * c_obj.abs().max().item(),
            "one bf16 ulp of the largest logit"),
        "boxes": bf16_far(
            "detector bf16 field boxes (card vs CPU bf16, from CPU fp32)",
            max_dist(k_boxes.cpu(), c_boxes), max_dist(p_boxes, c_boxes),
            bool(torch.isfinite(k_boxes).all()),
            ulp * c_boxes.abs().max().item(), "one bf16 ulp of the canvas")}
    del cpu, cpu16, g16
    return out


def phase13_detector(torch):
    """(A) The detector at `DetectorConfig()`'s defaults (canvas 640, trunk
    (64, 128, 256) x (2, 2, 2), head 256, 1,601 classes, 2,048-d features,
    pre-NMS 256, 50 regions, RoI 7) with seeded weights: the fp32 card
    against the CPU and bf16 by the 1.25 rule
    (`phase13_detector_check`); then in fp32 and bf16 at B 8 and 32: ms a
    batch and images/s, the CUDA-event ms of the trunk, the proposal heads,
    the top-k, NMS, RoI-align and the RoI head, the device kernels of one
    NMS call (in three profiles), the host ms of `_postprocess` an image and
    of the batch's copy to the host, and peak memory."""
    import dataclasses
    import gc
    import types
    from mvp_pytorch_tpu_torch.detection import Detector, DetectorConfig
    from mvp_pytorch_tpu_torch.detection.frontend import (DetectionFrontend,
                                                          default_label_map,
                                                          host_output)
    cfg = DetectorConfig(**DET_CONFIG)
    t0 = time.perf_counter()
    model = Detector(cfg, device=DEVICE, seed=0).eval()
    log(f"  detector: canvas {cfg.canvas}, trunk {tuple(cfg.stage_channels)}"
        f" x {tuple(cfg.stage_blocks)}, head {cfg.head_channels}, "
        f"{cfg.num_classes} classes, {cfg.feat_dim}-d features, pre-NMS "
        f"{cfg.pre_nms_topk}, {cfg.max_regions} regions, RoI "
        f"{cfg.roi_size}; {sum(p.numel() for p in model.parameters())} "
        f"parameters, seeded in {time.perf_counter() - t0:.1f} s")
    imgs = det_images(max(DET_BATCHES), cfg.canvas, seed=13)
    res = {"check": phase13_detector_check(torch, model, imgs)}
    state = model.state_dict()
    labels = types.SimpleNamespace(labels=default_label_map(cfg.num_classes))
    times = {}
    for dn in ("float32", "bfloat16"):
        m = Detector(dataclasses.replace(cfg, dtype=dn), device=DEVICE).eval()
        m.load_state_dict(state)
        for b in DET_BATCHES:
            x = torch.from_numpy(imgs[:b]).to(DEVICE)
            with torch.no_grad():
                row = {"ms": cuda_ms(lambda: m(x), iters=DET_ITERS)}
                row["trunk_ms"] = cuda_ms(lambda: m.trunk(x), iters=DET_ITERS)
                row["field_heads_ms"] = cuda_ms(
                    lambda: m.proposal_field(x),
                    iters=DET_ITERS) - row["trunk_ms"]
                obj, boxes, fmap = m.proposal_field(x)
                row["topk_ms"] = cuda_ms(lambda: m.top_proposals(obj, boxes))
                top = m.top_proposals(obj, boxes)
                row["nms_ms"] = cuda_ms(lambda: m.select(*top))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DET_ITERS):
                    m.select(*top)
                torch.cuda.synchronize()
                row["nms_wall_ms"] = (time.perf_counter() - t0) * 1e3 / \
                    DET_ITERS
                # three profiled calls: a profile may drop device events
                row["nms_kernels"] = [device_kernels(
                    torch, lambda: m.select(*top)) for _ in range(3)]
                sel = m.select(*top)
                row["roi_align_ms"] = cuda_ms(lambda: m.pool(fmap, sel[0]))
                pooled = m.pool(fmap, sel[0])
                row["roi_head_ms"] = cuda_ms(lambda: m.roi_head(pooled))
                del obj, boxes, fmap, top, sel, pooled
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                out = m(x)
                torch.cuda.synchronize()
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                t0 = time.perf_counter()
                host = host_output(out)
                row["to_host_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            rows = [DetectionFrontend._postprocess(labels, host, i,
                                                   cfg.canvas, cfg.canvas)
                    for i in range(b)]
            row["postprocess_ms_per_image"] = (
                (time.perf_counter() - t0) * 1e3 / b)
            row["images_per_s"] = b / (row["ms"] / 1e3)
            row["regions"] = [int(r[0].shape[0]) for r in rows]
            if not all(r[0].shape[1] == cfg.feat_dim + 6
                       and np.isfinite(r[0]).all() for r in rows):
                raise AssertionError(f"detector {dn} B {b}: bad rows")
            times[f"{dn} B {b}"] = row
            log(f"  detector {dn} B {b}: {row['ms']:.2f} ms a batch "
                f"({row['images_per_s']:.1f} images/s): trunk "
                f"{row['trunk_ms']:.2f}, proposal heads "
                f"{row['field_heads_ms']:.2f}, top-k {row['topk_ms']:.3f}, "
                f"NMS {row['nms_ms']:.3f} (wall {row['nms_wall_ms']:.3f}, "
                f"kernels in 3 profiles {row['nms_kernels']}), RoI-align "
                f"{row['roi_align_ms']:.3f}, RoI head "
                f"{row['roi_head_ms']:.3f} ms; peak {row['peak_gb']:.2f} GB; "
                f"to host {row['to_host_ms']:.2f} ms, _postprocess "
                f"{row['postprocess_ms_per_image']:.3f} ms an image; regions "
                f"{min(row['regions'])}-{max(row['regions'])}")
            del x, out, host
        del m
        gc.collect()
        torch.cuda.empty_cache()
    res["times"] = times
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase13_train(torch, root, quick=False):
    """(B) `train_detector` at its own default config for DET_TRAIN_STEPS
    steps, then `evaluate_map50` on DET_MAP_IMAGES held-out images, which
    must clear DET_MAP_FLOOR (`tests/test_detection.py`); and `train_cli` at
    its defaults (canvas 256, B 8), whose last DET_CLI_TAIL losses must
    average below DET_CLI_FALL of its first. ms a step. Returns the numbers
    and the CLI's checkpoint. `quick` runs the CLI only (for `--scst_cbs`)."""
    from mvp_pytorch_tpu_torch.detection import train_cli
    from mvp_pytorch_tpu_torch.detection.synthetic_boxes import (
        evaluate_map50, train_detector)
    res = {}
    if not quick:
        t0 = time.perf_counter()
        cfg, model, hist = train_detector(steps=DET_TRAIN_STEPS, batch=4,
                                          seed=0, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = evaluate_map50(cfg, model, n_images=DET_MAP_IMAGES)
        ok = m > DET_MAP_FLOOR and all(math.isfinite(v) for v in hist)
        res["synthetic"] = dict(steps=DET_TRAIN_STEPS,
                                ms_per_step=secs * 1e3 / DET_TRAIN_STEPS,
                                first_loss=hist[0], last_loss=hist[-1],
                                map50=m,
                                eval_s=time.perf_counter() - t0)
        log(f"  train_detector (canvas {cfg.canvas}, B 4): "
            f"{DET_TRAIN_STEPS} steps in {secs:.1f} s "
            f"({res['synthetic']['ms_per_step']:.2f} ms a step), loss "
            f"{hist[0]:.3f} -> {hist[-1]:.3f}; held-out mAP@0.5 on "
            f"{DET_MAP_IMAGES} images {m:.4f} (floor {DET_MAP_FLOOR})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the detector did not learn: mAP {m}")
        del model
    out = os.path.join(root, "det_ckpt")
    argv = ["--out_dir", out, "--steps", str(DET_TRAIN_STEPS),
            "--log_every", str(max(1, DET_TRAIN_STEPS // 4))] + (
                ["--platform", "cpu"] if DEVICE == "cpu" else [])
    log("  python -m mvp_pytorch_tpu_torch.detection.train_cli " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    t0 = time.perf_counter()
    cli = train_cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hist = cli["loss"]
    tail = mean(hist[-DET_CLI_TAIL:])
    ok = all(math.isfinite(v) for v in hist) and tail < DET_CLI_FALL * hist[0]
    res["cli"] = dict(steps=len(hist), ms_per_step=secs * 1e3 / len(hist),
                      first_loss=hist[0], last_loss=hist[-1], tail_mean=tail,
                      canvas=cli["config"].canvas)
    log(f"  detector train_cli (canvas {cli['config'].canvas}, B 8): "
        f"{len(hist)} steps in {secs:.1f} s "
        f"({res['cli']['ms_per_step']:.2f} ms a step with the save), loss "
        f"{hist[0]:.3f} -> {hist[-1]:.3f}, the last {DET_CLI_TAIL} "
        f"{tail:.3f} (< {DET_CLI_FALL} x first = "
        f"{DET_CLI_FALL * hist[0]:.3f})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"detector train_cli loss did not fall: {hist}")
    return res, out


def write_p13_root(root, det_ckpt):
    """Phase 13's root: a CLI_VOCAB-word vocab whose first 1,601 words name
    the detector's classes (label_map.json, single wordpieces), P13_IMAGES
    synthetic images at P13_CANVAS, their features extracted with the
    trained detector by `tools.img_feat_extract` (PNG files; without PIL,
    `detect` + `_postprocess` on the numpy canvases and the tool's own row
    writer), and P13_CAPS captions an image that open with its first tags.
    Returns the paths, which extraction ran and each row's regions."""
    from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
    from mvp_pytorch_tpu_torch.detection import DetectorConfig
    from mvp_pytorch_tpu_torch.tools import img_feat_extract as fx
    os.makedirs(root, exist_ok=True)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = [f"w{i}" for i in range(CLI_VOCAB - len(specials))]
    paths = {"vocab": os.path.join(root, "vocab.txt"),
             "labels": os.path.join(root, "label_map.json"),
             "captions": os.path.join(root, "captions.json"),
             "images": os.path.join(root, "images"),
             "features": os.path.join(root, "features", "predictions.tsv")}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(specials + words) + "\n")
    n_cls = DetectorConfig().num_classes
    with open(paths["labels"], "w") as f:
        json.dump({"label_to_idx": {words[i]: i for i in range(n_cls)}}, f)
    imgs = det_images(P13_IMAGES, P13_CANVAS, seed=131)
    names = [f"img_{i:03d}.png" for i in range(P13_IMAGES)]
    pixels = np.clip((imgs + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        os.makedirs(paths["images"], exist_ok=True)
        for name, px in zip(names, pixels):
            Image.fromarray(px).save(os.path.join(paths["images"], name))
        fx.main(["--image_dir", paths["images"], "--target_dir",
                 os.path.dirname(paths["features"]), "--od_ckpt", det_ckpt,
                 "--label_map", paths["labels"], "--batch_size", "8"]
                + (["--platform", "cpu"] if DEVICE == "cpu" else []))
        how = "tools.img_feat_extract over PNG files"
    else:
        from mvp_pytorch_tpu_torch.detection import DetectionFrontend
        from mvp_pytorch_tpu_torch.detection.frontend import host_output
        fe = DetectionFrontend(ckpt_dir=det_ckpt, label_map=paths["labels"],
                               device=DEVICE)
        canvases = pixels.astype(np.float32) / 127.5 - 1.0

        def rows():
            for s in range(0, P13_IMAGES, 8):
                out = host_output(fe.detect(canvases[s:s + 8]))
                for i, name in enumerate(names[s:s + 8]):
                    yield fx.feature_row(name, *fe._postprocess(
                        out, i, P13_CANVAS, P13_CANVAS))
        fx.write_features(os.path.dirname(paths["features"]), names, rows())
        how = ("detect + _postprocess on numpy canvases (no PIL), the tool's "
               "feature_row / write_features")
    store = FeatureStore(paths["features"])
    rng = np.random.default_rng(13)
    caps, regions = {}, []
    for name in names:
        feats, tags = store.get(name)
        regions.append(feats.shape[0])
        if feats.shape[1] != 2054 or feats.shape[0] > 50:
            raise AssertionError(f"{name}: regions {feats.shape}")
        caps[name] = [{"text": " ".join(
            tags[:3] + [words[int(w)] for w in rng.integers(
                n_cls, len(words), 12)])} for _ in range(P13_CAPS)]
    with open(paths["captions"], "w") as f:
        json.dump(caps, f)
    return paths, how, regions


def phase13_caption_cli(torch, root, det_ckpt):
    """(C) Image to features to constrained caption: `write_p13_root`, then
    the captioning CLI at MVPTR-base, bf16, on those features: `--do_train
    --max_steps 13 --scst --scst_steps 4 --scst_batch 8 --use_cbs
    --do_eval`. Holds the TSV's regions (2,054 wide, at most 50), finite SCST
    losses, and every CBS caption selected from a satisfying state holding
    its constraint token. Returns the numbers, the checkpoint and the
    dataset."""
    import shutil
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.tasks import captioning as cap
    t0 = time.perf_counter()
    paths, how, regions = write_p13_root(root, det_ckpt)
    extract_s = time.perf_counter() - t0
    log(f"  {P13_IMAGES} images at canvas {P13_CANVAS}: features by {how} "
        f"in {extract_s:.1f} s; regions a row {min(regions)}-{max(regions)} "
        f"(mean {mean(regions):.1f}), each 2,054 wide  ok")
    out = os.path.join(root, "cap")
    argv = (["--output_dir", out, "--captions_json", paths["captions"],
             "--feature_tsv", paths["features"], "--data_dir", root,
             "--do_train", "--max_steps", str(P13_STEPS), "--ckpt_period",
             str(P13_STEPS), "--train_batch_size", str(P13_B),
             "--log_period", "1", "--num_workers", "2",
             "--worker_start_method", "fork", "--do_eval", "--scst",
             "--scst_steps", str(P13_SCST_STEPS), "--scst_batch",
             str(SCST_B), "--use_cbs"] + CAP_ARGS + CLI_PLATFORM)
    log("  python -m mvp_pytorch_tpu_torch.tasks.captioning " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    t0 = time.perf_counter()
    res = cap.main(argv)
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in res["scst"]]
    cbs = res["cbs"]
    sat = [c for c in cbs["captions"].values() if c["satisfied"]]
    ok = (len(losses) == P13_SCST_STEPS
          and all(math.isfinite(v) for v in losses)
          and all(c["hit"] for c in sat) and len(sat) > 0
          and math.isfinite(res["eval"]["cider_d"]))
    log(f"  captioning CLI: {P13_STEPS} steps, {P13_SCST_STEPS} SCST steps "
        f"(losses " + ", ".join(f"{v:.4f}" for v in losses) + "), CBS "
        f"{cbs['n_hits']}/{cbs['n_images']} captions hold their tag, "
        f"{len(sat)} selected from a satisfying state and all of them hold "
        f"it; CIDEr-D after SCST {res['eval']['cider_d']:.4f}; {secs:.1f} s"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 13 captioning CLI: {losses} {cbs}")
    tokenizer = FastBertTokenizer(paths["vocab"])
    args = cap.get_args(argv)
    dataset = cap.CaptionDataset(
        args.captions_json, cap.FeatureStore(args.feature_tsv), tokenizer,
        args.max_seq_length, args.max_tag_length,
        max_img=args.max_img_seq_length)
    ckpt = os.path.join(out, f"checkpoint-{P13_STEPS:07d}")
    shutil.copy(paths["vocab"], ckpt)
    return (dict(extraction=how, extract_s=extract_s, regions=regions,
                 cli_s=secs, scst_losses=losses, cbs_hits=cbs["n_hits"],
                 cbs_images=cbs["n_images"], cbs_satisfied=len(sat),
                 cider_d=res["eval"]["cider_d"]),
            ckpt, dataset, tokenizer)


def cbs_constraints(dataset, tokenizer, images):
    """Two two-token constraints an image: its first four distinct tags as
    vocabulary tokens (filled from the caption words past the label map
    where an image has fewer)."""
    vocab = tokenizer.vocab
    fill = [vocab[f"w{i}"] for i in range(1700, 1710)]
    out = []
    for img in images:
        toks = []
        for t in dataset.features.get(img)[1]:
            if t in vocab and vocab[t] not in toks:
                toks.append(vocab[t])
        toks = (toks + [f for f in fill if f not in toks])[:4]
        out.append([toks[:2], toks[2:4]])
    return out


def phase13_cbs(torch, attn, layers_mod, ckpt, dataset, tokenizer):
    """(D) Constrained beam search at MVPTR-base on the CLI's checkpoint:
    CBS_IMAGES images, 2 two-token constraints each (S 8), K 3: 384 rows a
    step at L 90, 19 steps; 12 launches a step, 228 a search, all at Lk 90,
    p 0, the plain attention never. bf16: ms a step, captions/s, the
    top-k's device ms, peak memory. fp32 against the plain attention path:
    the same live slots, live-slot log-probs within CBS_TOL where the
    sequences agree, and the best sequences equal but at near ties (the
    best and runner-up length-normalised scores within CBS_TOL)."""
    import gc
    from mvp_pytorch_tpu_torch.models import CaptioningModel, ModelConfig
    from mvp_pytorch_tpu_torch.models.cbs import (
        NEG_INF, build_fsm, select_best_beam_with_constraints,
        top_k_lower_index)
    from mvp_pytorch_tpu_torch.tasks.captioning import (constrained_decode,
                                                         context_batch)
    vocab = tokenizer.vocab
    imgs = dataset.images()[:CBS_IMAGES]
    cons = cbs_constraints(dataset, tokenizer, imgs)
    model = load_checkpoint(torch, CaptioningModel, ckpt)
    v = model.config.vocab_size
    built = [build_fsm(c, v, max_states=CBS_STATES) for c in cons]
    fsm = torch.from_numpy(np.stack([b[0] for b in built])).to(DEVICE)
    nsat = built[0][1]
    ids_b, ctx_mask, feats = context_batch(dataset, imgs, DEVICE)
    layers = model.config.num_hidden_layers
    want = layers * (CAP_GEN - 1)

    def search(m):
        return constrained_decode(m, ids_b, ctx_mask, feats, fsm, vocab,
                                  gen_len=CAP_GEN, num_beams=CBS_BEAMS)
    search(model)                                    # warm-up
    reset_counts(attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with key_lengths(layers_mod) as seen:
        t0 = time.perf_counter()
        seqs, lps = search(model)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    if got != (want, 0, 0) or seen != [CAP_DEC_L] * want:
        raise AssertionError(f"CBS launches {got} (want {want}, 0, 0), key "
                             f"lengths {sorted(set(seen))}")
    n = CBS_IMAGES * CBS_STATES * CBS_BEAMS
    x = torch.randn(CBS_IMAGES, CBS_STATES * CBS_BEAMS * v, device=DEVICE)
    topk_ms = cuda_ms(lambda: top_k_lower_index(x, CBS_BEAMS))
    del x
    best, _ = select_best_beam_with_constraints(
        seqs.cpu().numpy(), lps.cpu().numpy(), nsat, 2,
        eos_token_ids=(vocab["[SEP]"],), pad_token_id=vocab["[PAD]"])
    live2 = (lps.cpu().numpy()[:, :, 0] > NEG_INF / 2) & (nsat >= 2)[None]
    hold = [all(t in best[i] for c in cons[i] for t in c)
            for i in range(CBS_IMAGES) if live2[i].any()]
    res = dict(rows=n, steps=CAP_GEN - 1, launches=got[0],
               launches_per_step=layers, seconds=secs,
               ms_per_step=secs * 1e3 / (CAP_GEN - 1),
               captions_per_s=CBS_IMAGES / secs, topk_ms=topk_ms,
               topk_ms_per_step=topk_ms * CBS_STATES, peak_gb=peak,
               satisfied_items=len(hold), satisfied_hold_all=all(hold))
    log(f"  CBS bf16: {CBS_IMAGES} images x S {CBS_STATES} x K {CBS_BEAMS}"
        f" = {n} rows a step at L {CAP_DEC_L}, {CAP_GEN - 1} steps, "
        f"{got[0]} launches ({layers} a step, p 0, plain 0); {secs:.3f} s, "
        f"{res['ms_per_step']:.2f} ms a step, {res['captions_per_s']:.1f} "
        f"captions/s; the top-k {topk_ms:.3f} device ms a destination state "
        f"({res['topk_ms_per_step']:.2f} a step); peak {peak:.2f} GB; "
        f"{len(hold)} images with a live state satisfying both "
        f"constraints, all tokens in the best caption: {all(hold)}")
    if not all(hold):
        raise AssertionError("a CBS caption from a satisfying state lacks a "
                             "constraint token")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = CaptioningModel(ModelConfig.from_pretrained(ckpt,
                                                        dtype="float32"),
                            device=DEVICE)
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     map_location=DEVICE, weights_only=True))
    reset_counts(attn)
    k_seqs, k_lps = (t.cpu().numpy() for t in search(model))
    with plain_attention_path(layers_mod, attn):
        p_seqs, p_lps = (t.cpu().numpy() for t in search(model))
    if attn.masked_attention.launches != want:
        raise AssertionError("the plain CBS path launched the kernel")
    live_k, live_p = k_lps > NEG_INF / 2, p_lps > NEG_INF / 2
    same = (k_seqs == p_seqs).all(-1) & live_k
    lp_err = float(np.abs(k_lps - p_lps)[same].max()) if same.any() else 0.0
    kb = select_best_beam_with_constraints(
        k_seqs, k_lps, nsat, 2, (vocab["[SEP]"],), vocab["[PAD]"])
    pb = select_best_beam_with_constraints(
        p_seqs, p_lps, nsat, 2, (vocab["[SEP]"],), vocab["[PAD]"])
    near, far = 0, []
    for i in np.nonzero((kb[0] != pb[0]).any(-1))[0]:
        if abs(kb[1][i] - pb[1][i]) < CBS_TOL:
            near += 1
        else:
            far.append(int(i))
    ok = (bool((live_k == live_p).all()) and lp_err <= CBS_TOL and not far)
    res["fp32"] = dict(live_slots=int(live_k.sum()),
                       differing_live_slots=int((live_k & ~same).sum()),
                       logprob_err=lp_err, best_differ_near_ties=near)
    log(f"  CBS fp32 kernel vs plain: {int(live_k.sum())} live slots, "
        f"the same in both; {int((live_k & ~same).sum())} with other "
        f"sequences; log-probs where they agree within {lp_err:.3e} (tol "
        f"{CBS_TOL:g}); best sequences differ in {near} images at near ties"
        f", {len(far)} elsewhere  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fp32 CBS kernel path is not the plain path's:"
                             f" {res['fp32']} {far}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def scst_grads(torch, model, batch, mask_id):
    """SCST's loss and the CAP_GRAD_PARAMS gradients of one copy forward and
    backward on fixed samples (dropout off)."""
    import types
    from mvp_pytorch_tpu_torch.tasks.captioning import scst_copy_loss
    model.eval()
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = scst_copy_loss(model, *batch, mask_id)
        loss.backward()
    params = dict(model.named_parameters())
    return (types.SimpleNamespace(loss=loss.detach()),
            {n: params[n].grad.detach().float().clone()
             for n in CAP_GRAD_PARAMS})


def phase13_scst(torch, attn, layers_mod, ckpt, dataset, tokenizer):
    """(E) SCST at MVPTR-base, bf16, `scst_batch` 8 at `max_gen_length` 20
    on the CLI's checkpoint, SCST_TIMED steps after a warm-up: host ms of a
    step's parts, each ended by a device sync (the sampled and the greedy
    cached decode, the host reward, the copy forward and its backward over
    160 rows at L 90, the update), peak memory, and exactly 492 launches a
    step (240 a cached decode, 12 the copy forward; the backward none), p 0,
    plain 0. Then one fp32 step on those samples, kernel path against plain
    path: the loss within 1e-4, five gradients within 1e-3 relative."""
    import gc
    from mvp_pytorch_tpu_torch.models import CaptioningModel, ModelConfig
    from mvp_pytorch_tpu_torch.tasks.captioning import (
        caption_tokens, context_batch, decode_output, scst_copy_loss,
        scst_optimizer)
    from mvp_pytorch_tpu_torch.training.scst import ScstReward, sample_mask
    vocab = tokenizer.vocab
    mask_id = vocab["[MASK]"]
    model = load_checkpoint(torch, CaptioningModel, ckpt)
    layers = model.config.num_hidden_layers
    want = 2 * layers * CAP_GEN + layers
    opt = scst_optimizer(model, 1e-6)
    reward = ScstReward()
    refs = dataset.references()
    imgs = dataset.images()[:SCST_B]
    ids_b, ctx_mask, feats = context_batch(dataset, imgs, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    parts, kept = [], None

    def step():
        t = {}

        def mark(name, t0):
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            return time.perf_counter()
        t0 = time.perf_counter()
        kw = dict(gen_len=CAP_GEN, decode_mode="cached")
        samp = decode_output(model, ids_b, ctx_mask, feats, vocab,
                             do_sample=True, generator=gen, **kw)
        t0 = mark("sample_decode_ms", t0)
        greedy = decode_output(model, ids_b, ctx_mask, feats, vocab, **kw)
        t0 = mark("greedy_decode_ms", t0)
        adv = reward.rewards(
            [caption_tokens(r, tokenizer) for r in samp.sequences.cpu()
             .numpy()],
            [caption_tokens(r, tokenizer) for r in greedy.sequences.cpu()
             .numpy()], [refs[i] for i in imgs])
        mask = sample_mask(samp.lengths, samp.finished, CAP_GEN)
        t0 = mark("reward_ms", t0)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = scst_copy_loss(model, samp.sequences, mask, adv, ids_b,
                                  ctx_mask, feats, mask_id)
            t0 = mark("copy_forward_ms", t0)
            loss.backward()
        t0 = mark("copy_backward_ms", t0)
        opt.step()
        mark("update_ms", t0)
        t["loss"] = loss.item()
        return t, (samp.sequences, mask, adv)

    step()                                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SCST_TIMED):
        reset_counts(attn)
        t, kept = step()
        got = (attn.masked_attention.launches,
               attn.masked_attention.dropout_launches,
               attn.plain_attention.calls)
        if got != (want, 0, 0) or not math.isfinite(t["loss"]):
            raise AssertionError(f"SCST step: launches {got} (want {want}, "
                                 f"0, 0), loss {t['loss']}")
        parts.append(t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = {k: mean([p[k] for p in parts]) for k in parts[0]}
    res["step_ms"] = sum(v for k, v in res.items() if k.endswith("_ms"))
    res.update(launches_per_step=want, peak_gb=peak, rows=SCST_B * CAP_GEN)
    log(f"  SCST bf16 (B {SCST_B}, {CAP_GEN} positions, copy forward over "
        f"{SCST_B * CAP_GEN} rows at L {CAP_DEC_L}): {want} launches a step "
        f"(p 0, plain 0); a step {res['step_ms']:.1f} ms: sample decode "
        f"{res['sample_decode_ms']:.1f}, greedy {res['greedy_decode_ms']:.1f}"
        f", reward (host) {res['reward_ms']:.1f}, copy forward "
        f"{res['copy_forward_ms']:.1f}, backward {res['copy_backward_ms']:.1f}"
        f", update {res['update_ms']:.1f} ms; peak {peak:.2f} GB; losses "
        + ", ".join(f"{p['loss']:.4f}" for p in parts))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    model = CaptioningModel(ModelConfig.from_pretrained(ckpt,
                                                        dtype="float32"),
                            device=DEVICE)
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     map_location=DEVICE, weights_only=True))
    batch = kept + (ids_b, ctx_mask, feats)
    reset_counts(attn)
    k_out, k_grads = scst_grads(torch, model, batch, mask_id)
    if attn.masked_attention.launches != layers:
        raise AssertionError("the fp32 SCST copy forward did not launch the "
                             "kernel in every layer")
    with plain_attention_path(layers_mod, attn):
        p_out, p_grads = scst_grads(torch, model, batch, mask_id)
    compare_step(torch, "SCST fixed samples", "float32", k_out, p_out,
                 ("loss",), k_grads, p_grads)
    res["fp32"] = {"loss": abs(k_out.loss.item() - p_out.loss.item())}
    res["fp32"].update({n: ((k_grads[n] - p_grads[n]).norm()
                            / p_grads[n].norm()).item()
                        for n in CAP_GRAD_PARAMS})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase13_kernel(torch, attn):
    """The kernel at the CBS step shape (L 90, N 384) and the SCST copy
    shape (L 90, N 160, forward and recompute backward), both under the
    recompute forward's seq2seq bias, in both dtypes: against the plain
    version (fp32 2e-5, bf16 0.05; the copy's grads against fp32 autograd
    of the plain version, 1e-4 / 0.05), timed beside the plain version,
    SDPA (a yardstick the port never calls) and the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(131)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    times = {}
    lq = lk = CAP_DEC_L
    for name, n, grads in P13_TIMED:
        for dn, dt in dtypes.items():
            q, k, v, g = (torch.randn(n, lq, H, D, device=DEVICE,
                                      generator=gen).to(dt) for _ in range(4))
            bias = caption_bias(torch, attn, gen, "recompute", n, lq)
            leaves = [t.detach().requires_grad_(grads) for t in (q, k, v)]
            before = attn.masked_attention.launches
            out = attn.masked_attention(*leaves, bias, layout="blhd")
            want = attn.plain_attention_blhd(q, k, v, bias)
            f_err = max_dist(out, want)
            b_err = 0.0
            if grads:
                got_g = torch.autograd.grad(out, leaves, g)
                ref = [t.detach().float().requires_grad_() for t in leaves]
                want_g = torch.autograd.grad(
                    attn.plain_attention_blhd(*ref, bias), ref, g.float())
                b_err = max(max_dist(a, c) for a, c in zip(got_g, want_g))
            torch.cuda.synchronize()
            ok = (f_err <= TOL[dn] and b_err <= GRAD_TOL[dn]
                  and attn.masked_attention.launches == before + 1)
            key = f"{name} N {n} L {lq}"
            log(f"  kernel vs plain  {key} {dn}: fwd max|err|={f_err:.3e} "
                f"(tol {TOL[dn]:g})" + (f"  grads {b_err:.3e} (tol "
                                        f"{GRAD_TOL[dn]:g})" if grads else "")
                + f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel at {key} {dn}: {f_err} {b_err}")
            x = [t.detach() for t in (q, k, v)]
            xh = [t.transpose(1, 2) for t in x]
            mask_lib = bias.to(dt)
            bound, by = attention_bound_ms(n, lq, lk, dn, bias)
            row = dict(
                max_abs_err=f_err, bound_ms=bound, bound_by=by,
                ms=cuda_ms(lambda: attn.masked_attention(*x, bias,
                                                         layout="blhd")),
                plain_ms=cuda_ms(lambda: attn.plain_attention_blhd(*x, bias),
                                 iters=5),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    *xh, attn_mask=mask_lib)))
            if grads:
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o = attn.masked_attention(*qkv, bias, layout="blhd")
                p_o = attn.plain_attention_blhd(*qkv, bias)
                qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                gh = g.transpose(1, 2)
                bwd_bound, bwd_by = attention_bwd_bound_ms(n, lq, lk, dn,
                                                           bias)
                row.update(
                    grad_err=b_err, bwd_bound_ms=bwd_bound,
                    bwd_bound_by=bwd_by,
                    bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                        o, qkv, g, retain_graph=True)),
                    plain_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                        p_o, qkv, g, retain_graph=True)),
                    sdpa_fwd_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                        F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask_lib),
                        (qh, kh, vh), gh)))
                del qkv, o, p_o, qh, kh, vh, gh
            times[key + (" fp32" if dn == "float32" else "")] = row
            log(f"  kernel {key} {dn}: kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f}  sdpa {row['sdpa_ms']:.4f}  bound "
                f"{bound:.4f} ({by})" + (
                    f"; backward {row['bwd_ms']:.4f}  plain "
                    f"{row['plain_bwd_ms']:.4f}  sdpa fwd+bwd "
                    f"{row['sdpa_fwd_bwd_ms']:.4f}  bound "
                    f"{row['bwd_bound_ms']:.4f} ({row['bwd_bound_by']})"
                    if grads else ""))
            del q, k, v, g, bias, leaves, out, want, x, xh, mask_lib
    torch.cuda.empty_cache()
    return times


def phase13(torch, attn, layers_mod, parts=("detection", "scst_cbs")):
    """Phase 13 on a root under `_smoke/`: with "detection", (A) the
    detector at full width and (B) its training; with "scst_cbs", (B)'s
    train_cli checkpoint (alone when "detection" is not asked), (C) the
    captioning CLI on its features with SCST and CBS, (D) CBS timed, (E)
    SCST timed, and the kernel at their shapes."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    res = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase13")
    shutil.rmtree(root, ignore_errors=True)
    try:
        if "detection" in parts:
            t0 = time.perf_counter()
            res["detector"] = phase13_detector(torch)
            res["detector"]["seconds"] = time.perf_counter() - t0
            log(f"  phase 13 A took {res['detector']['seconds']:.1f} s")
        t0 = time.perf_counter()
        res["train"], det_ckpt = phase13_train(
            torch, root, quick="detection" not in parts)
        res["train"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 13 B took {res['train']['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        if "scst_cbs" in parts:
            t0 = time.perf_counter()
            res["cli"], ckpt, dataset, tokenizer = phase13_caption_cli(
                torch, root, det_ckpt)
            res["cli"]["seconds"] = time.perf_counter() - t0
            log(f"  phase 13 C took {res['cli']['seconds']:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res["cbs"] = phase13_cbs(torch, attn, layers_mod, ckpt, dataset,
                                     tokenizer)
            res["cbs"]["phase_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["scst"] = phase13_scst(torch, attn, layers_mod, ckpt,
                                       dataset, tokenizer)
            res["scst"]["phase_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["kernel"] = phase13_kernel(torch, attn)
            log(f"  phase 13 D, E and the kernel rows took "
                f"{res['cbs']['phase_seconds']:.1f}, "
                f"{res['scst']['phase_seconds']:.1f} and "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13 took {res['seconds']:.1f} s")
    return res


def cbs_scst_summary(p13):
    """Phase 13's numbers for the kernel line (bf16 attention rows; the
    detector goes on a line of its own)."""
    return {"cli": p13.get("cli"), "cbs": p13.get("cbs"),
            "scst": p13.get("scst"),
            "attention": {k: v for k, v in p13.get("kernel", {}).items()
                          if not k.endswith("fp32")},
            "seconds": p13["seconds"]}


# phase 14: parallelism on torch.distributed. The script runs on one card,
# and NCCL refuses two ranks on one device, so the multi-rank equalities
# live in the CPU tests (gloo); here every path runs at world size 1 over
# NCCL, and MoE and the corpus-scale coarse stage at full size
P14_STEPS, P14_TIMED_FROM = 10, 4    # MoE CLI steps; timed from step 4
P14_MOE = ["--moe_experts", "8", "--moe_top_k", "2"]   # moe_every 2
P14_MEM_WARMUP, P14_MEM_TIMED = 2, 5  # in-memory steps, dense and MoE
P14_MODE_TIMED = 5                   # timed steps of each part B mode
P14_GPIPE_MB = 4
P14_FLICKR = (1000, 5)               # images, captions an image
P14_CORPUS = (100_000, 500_000)      # query rows (images), gallery rows
P14_K = (20, 10)                     # i2t, t2i shortlists
P14_BLOCK = 4096
P14_LAYERS = 12                      # a CPU rehearsal sets 4 (--tiny)
P14_EMB = 768
P14_MOE_GRADS = PRETRAIN_GRAD_PARAMS


def p14_launches(attn, want, what):
    """`want` p = 0 launches since `reset_counts`, the plain version never."""
    got = attn.masked_attention.launches
    drop = attn.masked_attention.dropout_launches
    plain = attn.plain_attention.calls
    if got != want or drop != 0 or plain != 0:
        raise AssertionError(f"{what}: {got} launches ({drop} with dropout), "
                             f"plain {plain}; want {want}, 0 and 0")


def phase14_moe(torch, attn, layers_mod, ModelConfig, root, p8=None):
    """(A) MVPTR-base with 8 experts top-2 in every second layer of each
    encoder: the pretraining CLI at B 96 and dropouts 0.1, then dense and
    MoE steps in memory on one batch, one fp32 step kernel path against
    plain path, and (D) the MoE run's state through the sharded format."""
    import dataclasses
    import gc
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.ops.moe import (collect_aux, moe_aux_loss,
                                               moe_dropped_share)
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.sharded_checkpoint import (
        consolidate, save_sharded)
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    per_step = P14_LAYERS // 2 * 4       # txt + vis + 2 fusion passes
    res = {}

    # 1. the command line
    out = os.path.join(root, "moe_cli")
    argv = (["--output_dir", out, "--synthetic", "--max_steps",
             str(P14_STEPS), "--ckpt_period", str(P14_STEPS),
             "--train_batch_size", str(TRAIN_B), "--log_period", "1",
             "--num_workers", "2", "--worker_start_method", "fork"]
            + P14_MOE + PRE_ARGS + CLI_PLATFORM)
    log("  python -m mvp_pytorch_tpu_torch.tasks.pretrain "
        + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                   for a in argv))
    with counted_steps(attn, per_step, "an MoE CLI step") as total:
        torch.cuda.reset_peak_memory_stats()
        hist = pre.main(argv)["train"]
    torch.cuda.synchronize()
    cli_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = check_losses(hist, P14_STEPS, "MoE CLI")
    aux = [m["moe_aux"] for m in hist]
    log("  MoE CLI aux " + " ".join(f"{x:.4f}" for x in aux))
    if not all(map(math.isfinite, aux)) or mean(losses[-3:]) >= losses[0]:
        raise AssertionError(f"MoE CLI: losses {losses}, aux {aux}")
    with open(os.path.join(out, f"checkpoint-{P14_STEPS:07d}",
                           "config.json")) as f:
        saved = json.load(f)
    experts = 3 * sum((i + 1) % saved["moe_every"] == 0
                      for i in range(saved["num_hidden_layers"] // 2))
    if saved["moe_experts"] != 8 or saved["moe_top_k"] != 2 or \
            experts != 3 * (P14_LAYERS // 2 // 2):
        raise AssertionError(f"MoE config {saved['moe_experts']} x top "
                             f"{saved['moe_top_k']}, {experts} MoE layers")
    res["cli"] = dict(cli_numbers(hist, TRAIN_B, cli_peak, P14_TIMED_FROM),
                      launches=total[0], launches_per_step=per_step,
                      moe_layers=experts, losses=losses, aux=aux)
    log(f"  MoE CLI: {P14_STEPS} steps, {total[0]} launches ({per_step} a "
        f"step, all with dropout, plain 0), {experts} MoE layers; steps "
        f"{P14_TIMED_FROM}-{P14_STEPS}: {res['cli']['step_ms']:.2f} ms/step "
        f"{res['cli']['samples_per_s']:.1f} samples/s, peak {cli_peak:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()

    # 2. dense against MoE in memory, one batch, the same Trainer
    step_kw = dict(max_tag_length=20, hn_mod="hard", phrase_mod="sample",
                   max_pred_a=20, max_pred_b=10)
    opt_kw = dict(schedule="constant", max_grad_norm=1.0)
    moe_kw = dict(moe_experts=8, moe_top_k=2)
    mem = {}
    for name, kw in (("dense", {}), ("moe", moe_kw)):
        cfg = base_config(ModelConfig, "bfloat16", DROP_P, **kw)
        model = BiPretrainModel(cfg, device=DEVICE, seed=0)
        batch = pretrain_batch(torch, cfg, seed=7)
        trainer = Trainer(model, pre.pretrain_loss_fn(
            moe_aux_weight=0.01 if kw else None, **step_kw),
            make_optimizer(model, 1e-4, **opt_kw), seed=1)
        for _ in range(P14_MEM_WARMUP):
            trainer.step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counted_steps(attn, per_step, f"a {name} pretraining step"):
            h = [trainer.step(batch) for _ in range(P14_MEM_TIMED)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / P14_MEM_TIMED
        mem[name] = dict(step_ms=ms, samples_per_s=TRAIN_B / ms * 1e3,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         params_m=sum(p.numel() for p in model.parameters())
                         / 1e6, loss=h[-1]["loss"])
        if kw:
            mem[name].update(aux=h[-1]["moe_aux"],
                             dropped_share=float(moe_dropped_share(model)))
        log(f"  in memory {name}: {ms:.2f} ms/step "
            f"{mem[name]['samples_per_s']:.1f} samples/s peak "
            f"{mem[name]['peak_gb']:.2f} GB, {mem[name]['params_m']:.1f} M "
            "params" + (f", aux {mem[name]['aux']:.4f}, dropped share "
                        f"{mem[name]['dropped_share']:.4f}" if kw else ""))
        if name == "moe":
            # (D) the state through the sharded format and back, bit for bit
            t0 = time.perf_counter()
            ckpt = os.path.join(root, "moe_shards")
            state = {"model": {k: v.detach() for k, v in
                               model.state_dict().items()},
                     "opt": trainer.optimizer_state_tree()}
            save_sharded(ckpt, state)
            whole = consolidate(ckpt)
            fresh = BiPretrainModel(cfg, device=DEVICE, seed=1)
            fresh.load_state_dict({k: torch.as_tensor(v) for k, v in
                                   whole["model"].items()}, strict=True)
            fresh_sd = fresh.state_dict()
            bad = [k for k, v in model.state_dict().items()
                   if not torch.equal(v, fresh_sd[k])]
            opt = trainer.optimizer
            for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
                bad += [f"{key}/{n}" for n, m in zip(opt.names, moments)
                        if not torch.equal(m.cpu(), torch.as_tensor(
                            whole["opt"][key][n]))]
            if bad or int(whole["opt"]["count"]) != opt.count:
                raise AssertionError(f"sharded round trip differs: {bad[:5]}")
            nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                         for f in os.listdir(ckpt))
            res["checkpoint"] = dict(seconds=time.perf_counter() - t0,
                                     gb=nbytes / 1e9,
                                     tensors=len(model.state_dict())
                                     + 2 * len(opt.names))
            log(f"  (D) sharded save + consolidate + restore of the MoE "
                f"state: {res['checkpoint']['gb']:.2f} GB, "
                f"{res['checkpoint']['tensors']} tensors, bit for bit, in "
                f"{res['checkpoint']['seconds']:.1f} s")
            del fresh, state, whole
        del trainer, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    res["in_memory"] = mem
    res["moe_over_dense_step"] = mem["moe"]["step_ms"] / mem["dense"]["step_ms"]
    if p8 is not None:
        res["phase8_dense"] = {k: p8[k] for k in ("step_ms", "samples_per_s",
                                                  "peak_gb")}

    # 3. one fp32 MoE step at p 0, kernel path against plain path
    cfg = base_config(ModelConfig, "float32", **moe_kw)
    model = BiPretrainModel(cfg, device=DEVICE, seed=0)
    model.train()
    batch = pretrain_batch(torch, cfg, seed=8)
    dice = torch.randperm(TRAIN_B, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(9))

    def step():
        model.zero_grad(set_to_none=True)
        with collect_aux(model) as aux_values:
            out = model.train_step(
                *(batch.get(k) for k in pre.PRETRAIN_KEYS), hn_dice=dice,
                wra_pick=1, wra_neg_offset=1,
                generator=torch.Generator(device=DEVICE).manual_seed(0),
                **step_kw)
        aux = moe_aux_loss(aux_values)
        (out.total_loss + 0.01 * aux).backward()
        params = dict(model.named_parameters())
        return out, aux, {n: params[n].grad.detach().clone()
                          for n in P14_MOE_GRADS}

    reset_counts(attn)
    with hard_pairs(model) as mined:
        k_out, k_aux, k_grads = step()
    torch.cuda.synchronize()
    p14_launches(attn, per_step, "the fp32 MoE step")
    with plain_attention_path(layers_mod, attn), hard_pairs(
            model, pinned=mined[0]):
        p_out, p_aux, p_grads = step()
    torch.cuda.synchronize()
    if attn.masked_attention.launches != per_step:
        raise AssertionError("plain path launched the kernel")
    compare_step(torch, "MoE step", "float32", k_out, p_out,
                 [n for n in PRETRAIN_LOSSES if n != "qa_loss"], k_grads,
                 p_grads)
    aux_err = abs(k_aux.item() - p_aux.item())
    log(f"  MoE step float32 aux kernel={k_aux.item():.6f} "
        f"plain={p_aux.item():.6f} |diff|={aux_err:.3e}")
    if aux_err > STEP_TOL["float32"][0]:
        raise AssertionError(f"MoE aux {k_aux.item()} vs {p_aux.item()}")
    res["fp32_check"] = dict(loss=k_out.total_loss.item(),
                             loss_err=abs(k_out.total_loss.item()
                                          - p_out.total_loss.item()),
                             aux_err=aux_err)
    del model, batch, k_out, p_out, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase14_world1(torch, attn, ModelConfig, RetrievalModel):
    """(B) one retrieval step at B 96, fp32, p 0, under plain DDP, DDP with
    ZeRO-2, FSDP, TP (model 1) and GPipe (one stage, 4 microbatches), on a
    process group of one rank over NCCL; each against the plain Trainer's
    step (loss 1e-4, the five updates 1e-3 relative), then timed."""
    import dataclasses
    import gc
    from mvp_pytorch_tpu_torch.parallel import distributed
    from mvp_pytorch_tpu_torch.parallel.mesh import (apply_tensor_parallel,
                                                     make_mesh)
    from mvp_pytorch_tpu_torch.tasks.retrieval import retrieval_loss_fn
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    info = distributed.initialize("cpu" if DEVICE == "cpu" else None,
                                  need_group=True)
    want = "gloo" if DEVICE == "cpu" else "nccl"
    log(f"  process group: rank {info['rank']} of {info['world_size']} on "
        f"{info['device']} over {info['backend']}")
    if info["backend"] != want or info["world_size"] != 1:
        raise AssertionError(f"want one {want} rank: {info}")
    mesh = make_mesh(register=False)
    per_step = P14_LAYERS // 2 * 4
    cfg = base_config(ModelConfig, "float32")
    batch = train_batch(torch, cfg, seed=5)
    loss_fn = retrieval_loss_fn(max_tag_length=20, hn_mod="hard")
    modes = {"plain": dict(mesh=None), "ddp": dict(zero_sharding=False),
             "zero2": dict(), "fsdp": dict(fsdp=True), "tp": dict(),
             "gpipe": dict(pipeline_microbatches=P14_GPIPE_MB)}
    ref, out = None, {}
    try:
        for mode, kw in modes.items():
            mcfg = (dataclasses.replace(cfg, pipeline_stages=1)
                    if mode == "gpipe" else cfg)
            model = RetrievalModel(mcfg, device=DEVICE, seed=0)
            if mode == "tp":
                apply_tensor_parallel(model, mesh)
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()
                      if n in GRAD_PARAMS}
            trainer = Trainer(model, loss_fn, make_optimizer(
                model, 4e-5, schedule="constant"), seed=1,
                **{"mesh": mesh, **kw})
            launches = per_step * (P14_GPIPE_MB if mode == "gpipe" else 1)
            reset_counts(attn)
            first = trainer.step(batch)
            torch.cuda.synchronize()
            p14_launches(attn, launches, f"the {mode} step")
            after = trainer.full_state_dict()
            upd = {n: (after[n] - before[n]).float() for n in before}
            if ref is None:
                ref = (first, upd)
                errs = {}
            else:
                loss_err = abs(first["loss"] - ref[0]["loss"])
                errs = {n: ((u - ref[1][n]).norm()
                            / ref[1][n].norm().clamp(min=1e-30)).item()
                        for n, u in upd.items()}
                ok = (loss_err <= STEP_TOL["float32"][0] and
                      max(errs.values()) <= STEP_TOL["float32"][1])
                log(f"  {mode:6s} loss {first['loss']:.6f} (|diff| "
                    f"{loss_err:.3e}), updates rel err max "
                    f"{max(errs.values()):.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{mode} step: loss {loss_err}, "
                                         f"updates {errs}")
            steps_ms = []
            for _ in range(P14_MODE_TIMED):
                reset_counts(attn)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step(batch)
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
                p14_launches(attn, launches, f"a {mode} step")
            # the median: a host hiccup in one step moves the mean by tens
            # of ms at world size 1
            ms = float(np.median(steps_ms))
            out[mode] = dict(step_ms=ms, steps_ms=steps_ms,
                             loss=first["loss"], launches_per_step=launches,
                             max_update_rel_err=max(errs.values(),
                                                    default=0.0))
            log(f"  {mode:6s} {ms:.2f} ms/step median of "
                f"{', '.join(f'{t:.2f}' for t in steps_ms)} ({launches} "
                f"launches a step)")
            del trainer, model, after, before, upd
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    return out


def phase14_coarse(torch):
    """(C) `--coarse_block`'s streaming coarse stage: at the Flickr geometry
    against the dense coarse stage of `two_stage_scoring` (tie-free), then a
    corpus-scale pass whose dense matrix would not fit."""
    from mvp_pytorch_tpu_torch.parallel.sharded_retrieval import (
        sharded_coarse_eval)
    from mvp_pytorch_tpu_torch.tasks.retrieval_eval import coarse_ranks
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    k_i2t, k_t2i = P14_K

    def emb(n):
        x = torch.randn(n, P14_EMB, device=DEVICE, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    n_img, cpi = P14_FLICKR
    n_cap = n_img * cpi
    # exact and tie-free by construction: entries -1, 0, 1 give integer
    # scores (exact in fp32 in any order of summation), and two last
    # columns add (i + j) / 8192 to the score of image i and caption j, so
    # no two scores of a row or a column are equal (i + j < 8192)
    img = torch.randint(-1, 2, (n_img, P14_EMB), device=DEVICE,
                        generator=gen).float()
    txt = torch.randint(-1, 2, (n_cap, P14_EMB), device=DEVICE,
                        generator=gen).float()
    img[:, -2] = torch.arange(n_img, device=DEVICE) / 8192
    txt[:, -2] = 1.0
    img[:, -1] = 1.0
    txt[:, -1] = torch.arange(n_cap, device=DEVICE) / 8192
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = img @ txt.T
    i2t = torch.topk(sims, k_i2t, dim=1).indices.cpu().numpy()
    t2i = torch.topk(sims.T, k_t2i, dim=1).indices.cpu().numpy()
    ri, rt = coarse_ranks(sims.cpu().numpy(), cpi)
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = sharded_coarse_eval(img, txt, cpi, k_i2t, k_t2i, block=P14_BLOCK)
    stream_s = time.perf_counter() - t0
    for name, a, b in zip(("i2t", "t2i", "i2t ranks", "t2i ranks"), got,
                          (i2t, t2i, ri, rt)):
        if not np.array_equal(a, b):
            raise AssertionError(f"--coarse_block {name} differs from the "
                                 f"dense stage in {(a != b).sum()} places")
    log(f"  Flickr geometry {n_img} x {n_cap} (exact, tie-free scores): "
        f"shortlists and ranks "
        f"equal the dense stage; dense {dense_s:.3f} s, streaming "
        f"{stream_s:.3f} s (block {P14_BLOCK})")
    del img, txt, sims

    nq, ng = P14_CORPUS
    img, txt = emb(nq), emb(ng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    i2t_c, t2i_c, ri_c, rt_c = sharded_coarse_eval(
        img, txt, ng // nq, k_i2t, k_t2i, block=P14_BLOCK)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if (i2t_c.shape != (nq, k_i2t) or t2i_c.shape != (ng, k_t2i)
            or i2t_c.min() < 0 or i2t_c.max() >= ng or ri_c.max() >= ng
            or rt_c.max() >= nq or ri_c.min() < 0):
        raise AssertionError("corpus-scale coarse stage: bad shapes or ids")
    dense_gb = nq * ng * 4 / 1e9
    log(f"  corpus scale {nq} x {ng} (dense fp32 matrix {dense_gb:.0f} GB): "
        f"both directions' shortlists and ranks in {corpus_s:.2f} s, peak "
        f"{peak:.2f} GB")
    del img, txt
    torch.cuda.empty_cache()
    return dict(flickr=dict(dense_s=dense_s, streaming_s=stream_s,
                            equal=True),
                corpus=dict(queries=nq, gallery=ng, seconds=corpus_s,
                            peak_gb=peak, dense_matrix_gb=dense_gb,
                            block=P14_BLOCK))


def phase14(torch, attn, layers_mod, ModelConfig, RetrievalModel, p8=None):
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase14")
    shutil.rmtree(root, ignore_errors=True)
    try:
        log("  (A) MoE pretraining, MVPTR-base, 8 experts top-2, B "
            f"{TRAIN_B}, dropouts {DROP_P}")
        moe = phase14_moe(torch, attn, layers_mod, ModelConfig, root, p8)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  (B) world size 1 on the card: plain, DDP, ZeRO-2, FSDP, TP, "
        f"GPipe ({P14_GPIPE_MB} microbatches), B {TRAIN_B} fp32")
    world1 = phase14_world1(torch, attn, ModelConfig, RetrievalModel)
    log("  (C) --coarse_block's streaming coarse stage")
    coarse = phase14_coarse(torch)
    log("  the kernel at GPipe's microbatch shapes")
    gpipe_attention = attention_times(
        torch, attn, tuple((name, TRAIN_B // P14_GPIPE_MB, l, "float32",
                            (0.0,), "key")
                           for name, l in (("text", 75), ("vis", 70),
                                           ("fused", 125))), seed=14)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 14 took {seconds:.1f} s")
    return dict(moe=moe, world1=world1, coarse=coarse,
                gpipe_attention=gpipe_attention, seconds=seconds)


def parallel_summary(p14):
    """Phase 14's numbers for the kernel line (the GPipe microbatch rows go
    with the fp32 kernel)."""
    return {k: v for k, v in p14.items() if k != "gpipe_attention"}


# ---------------------------------------------------------------------------
# phase 15: the tooling around the training loop (the trace window, the
# async checkpoint, the preemption checkpoint, inspect_ckpt, the load test)
# ---------------------------------------------------------------------------

P15_STEPS = 8                        # part A's CLI steps
P15_PROFILE = (3, 2)                 # --profile_start (0-based), --profile_steps
P15_FREE_STEPS = 5                   # part B's steps with no write in flight
P15_DEADLINE_S = 300                 # part C's subprocess, to its first line and to exit
P15_RESUME = 3                       # part C resumes to s + 3
P15_WEIGHT_TOL = 1e-6
P15_MEM_TOL = 0.01                   # metrics.jsonl memory against the allocator
P15_LOAD = {"requests": 200, "threads": 16, "checked": 16}
# the JAX bench's flagship serving config (bench.py:644-663)
P15_SERVE = dict(hidden=768, layers=12, dtype="bfloat16", store_bf16=True,
                 vocab_rows=30522, vocab_extra=86051 - 30522,
                 max_position_embeddings=512)
LIBRARY_ATTENTION = ("flash", "fmha", "sdpa", "efficient_attention",
                     "scaled_dot_product")


def trace_kernels(path):
    """(device kernel names of a Chrome trace, by `kernel_key` where the name
    is mangled, else without its unnamed namespaces; and the number of
    `train_step` regions on the host: the profiler mirrors each on the
    device's timeline as a `gpu_user_annotation`)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    steps = sum(1 for e in events if e.get("name") == "train_step"
                and e.get("cat") == "user_annotation")
    return [kernel_key(n) if n.startswith("_Z")
            else n.replace("(anonymous namespace)::", "")
            for n in names], steps


def phase15_trace(torch, attn, paths, root, data):
    """(A) The retrieval CLI with a trace window: one trace file holding the
    window's kernel launches and no library attention."""
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tasks.common import build_config
    start, n = P15_PROFILE
    out = os.path.join(root, "trace_run")
    prof = os.path.join(root, "trace")
    argv = (["--output_dir", out, "--do_train", "--max_steps", str(P15_STEPS),
             "--train_batch_size", str(TRAIN_B), "--log_period", "1",
             "--ckpt_period", str(P15_STEPS), "--num_workers", "4",
             "--worker_start_method", "fork", "--data_dir", root,
             "--profile_dir", prof, "--profile_start", str(start),
             "--profile_steps", str(n)] + data + CLI_ARGS + CLI_PLATFORM)
    log("  python -m mvp_pytorch_tpu_torch.tasks.retrieval "
        + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                   for a in argv))
    counts = {}         # step -> its launches

    def after(trainer, metrics):
        counts[trainer.step_count] = attn.masked_attention.launches
    per_step = build_config(ret.get_args(argv),
                            FastBertTokenizer(paths["vocab"]),
                            num_labels=2).half_layers * 4
    with counted_steps(attn, per_step, "a traced CLI step"):
        with around_steps(after=after):
            hist = ret.main(argv)["train"]
    peak = torch.cuda.max_memory_allocated() / 1024.0 ** 3
    files = sorted(os.listdir(prof))
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise AssertionError(f"want one trace file, got {files}")
    names, steps = trace_kernels(os.path.join(prof, files[0]))
    window = sum(counts[s] for s in range(start + 1, start + n + 1))
    ours = [k for k in names if "masked_attention" in k]
    library = sorted({k for k in names
                      if any(w in k.lower() for w in LIBRARY_ATTENTION)})
    log(f"  trace {files[0]}: {len(names)} device kernels, {len(ours)} of "
        f"the hand-written kernel ({sorted(set(ours))[:2]}), {steps} "
        f"train_step regions; launch counter over steps {start + 1}-"
        f"{start + n}: {window}; library attention kernels: {library}")
    if steps != n or library or (
            DEVICE == "cuda" and (len(ours) != window
                                  or window != per_step * n)):
        raise AssertionError(f"the trace holds {len(ours)} kernel launches "
                             f"over {steps} steps (counter {window}), "
                             f"library attention {library}")
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    mem = {k: last.get(f"train/{k}") for k in ("hbm_peak_gb", "step_peak_gb",
                                               "step_args_gb", "step_temp_gb",
                                               "hbm_gb", "hbm_limit_gb")}
    log(f"  metrics.jsonl memory {json.dumps(mem)}; "
        f"torch.cuda.max_memory_allocated {peak:.4f} GB")
    for k in ("hbm_peak_gb", "step_peak_gb") if DEVICE == "cuda" else ():
        if mem[k] is None or abs(mem[k] - peak) > P15_MEM_TOL * peak:
            raise AssertionError(f"{k} {mem[k]} is not within 1 % of the "
                                 f"allocator's peak {peak}")
    ms = [m["step_ms"] for m in hist]
    # the window's first step carries the profiler's start, the step after
    # it the trace's export
    inside = float(np.median(ms[start + 1:start + n]))
    outside = float(np.median(ms[1:start] + ms[start + n + 1:]))
    log(f"  step ms: traced {inside:.2f} (steps {start + 2}-{start + n}), "
        f"untraced {outside:.2f} (steps 2-{start}, {start + n + 2}-"
        f"{P15_STEPS}); the profiler's start (step {start + 1}) "
        f"{ms[start]:.1f}, the export (step {start + n + 1}) "
        f"{ms[start + n]:.1f}")
    return dict(trace_launches=len(ours), window_launches=window,
                trace_kernels=len(names), step_ms_traced=inside,
                step_ms_untraced=outside, start_step_ms=ms[start],
                export_step_ms=ms[start + n],
                memory_gb=mem, max_memory_allocated_gb=peak,
                ckpt=os.path.join(out, f"checkpoint-{P15_STEPS:07d}"))


def phase15_async(torch, attn, paths, root, data, ckpt_dir):
    """(B) One trained state saved synchronously and through AsyncSaver (the
    snapshot, then the write while steps run): equal bit for bit."""
    import threading
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore,
                                                     RetrievalDataset,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tasks.common import tensorize_cfg
    from mvp_pytorch_tpu_torch.training.checkpoint import (AsyncSaver,
                                                           CheckpointManager)
    from mvp_pytorch_tpu_torch.training.loop import batch_on
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    args = ret.get_args(["--output_dir", root] + data + CLI_ARGS
                        + CLI_PLATFORM)
    cfg = ModelConfig.from_pretrained(ckpt_dir)
    model = RetrievalModel(cfg, device=DEVICE, seed=args.seed)
    opt = make_optimizer(model, args.learning_rate,
                         weight_decay=args.weight_decay, schedule="constant")
    restored = CheckpointManager(os.path.dirname(ckpt_dir))
    meta = restored.restore(ckpt_dir, model, opt)
    tokenizer = FastBertTokenizer(paths["vocab"])
    dataset = RetrievalDataset(
        paths["captions"], FeatureStore(paths["features"]), tokenizer,
        sg2id=load_phrase_vocab(paths["id2phrase"]), cfg=tensorize_cfg(args))
    batch = batch_on(model.device, ret.RetrievalFetch(dataset, False)(
        BatchSampler(len(dataset), TRAIN_B, seed=args.seed).batch_at(0)))
    trainer = Trainer(model, ret.retrieval_loss_fn(
        max_tag_length=args.max_tag_length), opt, seed=args.seed)
    trainer.step_count = int(meta["step"])
    step = trainer.step_count
    per_step = cfg.half_layers * 4
    sync_dir, async_dir = (os.path.join(root, "save_sync"),
                           os.path.join(root, "save_async"))
    t0 = time.perf_counter()
    CheckpointManager(sync_dir).save(step, model, opt, config=cfg)
    sync_s = time.perf_counter() - t0
    saver, done = AsyncSaver(), threading.Event()
    mgr = CheckpointManager(async_dir)
    with counted_steps(attn, per_step, "a step during an async write"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = mgr.snapshot(step, model, opt, config=cfg)

        def write():
            try:
                mgr.write(snap)
            finally:
                done.set()      # saver.wait() re-raises a failed write
        saver.submit(write)
        block_s = time.perf_counter() - t0
        during = []
        while not done.is_set():
            t = time.perf_counter()
            trainer.step(batch)
            during.append((time.perf_counter() - t) * 1e3)
        write_s = time.perf_counter() - t0
        saver.wait()
        free = []
        for _ in range(P15_FREE_STEPS):
            t = time.perf_counter()
            trainer.step(batch)
            free.append((time.perf_counter() - t) * 1e3)
    name = f"checkpoint-{step:07d}"
    equal = True
    for fname in ("pytorch_model.bin", "optimizer.pt"):
        a = torch.load(os.path.join(sync_dir, name, fname),
                       weights_only=True)
        b = torch.load(os.path.join(async_dir, name, fname),
                       weights_only=True)
        for key in ("mu", "nu") if fname == "optimizer.pt" else (None,):
            ta, tb = (a, b) if key is None else (a[key], b[key])
            equal &= sorted(ta) == sorted(tb) and all(
                ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k])
                for k in ta)
        if fname == "optimizer.pt":
            equal &= a["count"] == b["count"]
    n_params = sum(v.numel() for v in model.state_dict().values())
    during_ms = float(np.median(during)) if during else float("nan")
    free_ms = float(np.median(free))
    log(f"  save: sync {sync_s:.2f} s; async submit blocked {block_s:.2f} s "
        f"(the snapshot), the write took {write_s:.2f} s, {len(during)} "
        f"steps ran meanwhile at median {during_ms:.2f} ms, against "
        f"{free_ms:.2f} ms with no write; the two checkpoints "
        f"{'equal' if equal else 'DIFFER'} bit for bit")
    if not equal:
        raise AssertionError("the async checkpoint differs from the sync one")
    del model, opt, trainer, snap
    return dict(sync_s=sync_s, async_block_s=block_s, async_write_s=write_s,
                steps_during_write=len(during), step_ms_during_write=during_ms,
                step_ms_no_write=free_ms), n_params


def phase15_preempt(torch, attn, paths, root, data, n_params):
    """(C) SIGTERM to the CLI's process group: rc 0, one checkpoint at s,
    and a resume to s + 3 equal to an uninterrupted run to s + 3."""
    import signal
    from mvp_pytorch_tpu_torch.models import ModelConfig
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tools import inspect_ckpt
    out = os.path.join(root, "preempted")
    flags = (["--do_train", "--train_batch_size", str(TRAIN_B),
              "--log_period", "1", "--num_workers", "4",
              "--worker_start_method", "fork", "--data_dir", root,
              "--scheduler", "constant"] + data + CLI_ARGS
             + ["--dtype", "float32"] + CLI_PLATFORM)
    argv = (["--output_dir", out, "--max_steps", "500", "--ckpt_period",
             "500", "--async_ckpt"] + flags)
    log("  python -m mvp_pytorch_tpu_torch.tasks.retrieval "
        + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                   for a in argv) + "  (own session; SIGTERM to its group)")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tasks.retrieval"]
        + argv, cwd=here, start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    metrics = os.path.join(out, "train_logs", "metrics.jsonl")
    deadline = time.monotonic() + P15_DEADLINE_S
    try:
        while not (os.path.exists(metrics) and os.path.getsize(metrics)):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"no metrics line (rc {proc.poll()}): "
                    f"{proc.stdout.read()[-3000:] if proc.poll() is not None else ''}")
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGTERM)
        t_sig = time.perf_counter()
        output, _ = proc.communicate(timeout=P15_DEADLINE_S)
        exit_s = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    ckpts = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    log(f"  preempted: rc {proc.returncode}, {exit_s:.2f} s from SIGTERM to "
        f"exit, checkpoints {ckpts}; "
        + " | ".join(line for line in output.splitlines()
                     if "preemption" in line or "SIGTERM" in line))
    if proc.returncode != 0 or len(ckpts) != 1:
        raise AssertionError(f"preempted run: rc {proc.returncode}, "
                             f"{ckpts}: {output[-3000:]}")
    s = int(ckpts[0].split("-")[-1])
    if not 1 <= s < 500:
        raise AssertionError(f"preemption checkpoint at step {s}")
    info = inspect_ckpt.describe_dir(os.path.join(out, ckpts[0]))
    log(f"  inspect_ckpt: format {info['format']}, n_params "
        f"{info['n_params']:,} in {info['n_leaves']} tensors, dtypes "
        f"{info['dtypes']}; the model's numel {n_params:,}")
    if info["n_params"] != n_params:
        raise AssertionError("inspect_ckpt's n_params is not the model's")
    per_step = ModelConfig.from_pretrained(
        os.path.join(out, ckpts[0])).half_layers * 4
    whole = os.path.join(root, "uninterrupted")
    with counted_steps(attn, per_step, "an fp32 resumed step"):
        resumed = ret.main(["--output_dir", out, "--max_steps",
                            str(s + P15_RESUME)] + flags)["train"]
        straight = ret.main(["--output_dir", whole, "--max_steps",
                             str(s + P15_RESUME)] + flags)["train"]
    name = f"checkpoint-{s + P15_RESUME:07d}"
    a = torch.load(os.path.join(out, name, "pytorch_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(whole, name, "pytorch_model.bin"),
                   weights_only=True)
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    log(f"  resumed {len(resumed)} steps to {s + P15_RESUME}; losses "
        + " ".join(f"{m['loss']:.6f}" for m in resumed) + " against "
        + " ".join(f"{m['loss']:.6f}" for m in straight[s:])
        + f"; weights max|diff| {diff:.3e} (tol {P15_WEIGHT_TOL:g})")
    if sorted(a) != sorted(b) or diff > P15_WEIGHT_TOL:
        raise AssertionError("the resume differs from the uninterrupted run")
    return dict(preempt_step=s, sigterm_to_exit_s=exit_s,
                resume_max_diff=diff, n_params=info["n_params"])


def phase15_load_test(torch, attn, root):
    """(D) The load-test client at the JAX bench's serving config, batched
    then unbatched."""
    from mvp_pytorch_tpu_torch.models import ModelConfig
    from mvp_pytorch_tpu_torch.tools import load_test_serve
    t0 = time.perf_counter()
    mdir, paths, vocab = load_test_serve.build_assets(
        os.path.join(root, "serve"), **P15_SERVE)
    cfg = ModelConfig.from_pretrained(mdir)
    log(f"  serving assets: hidden {cfg.hidden_size}, "
        f"{cfg.num_hidden_layers} layers, {vocab} vocab rows, "
        f"{cfg.vocab_size} model rows, bf16 stored bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts(attn)
    res = load_test_serve.main(
        ["--device", DEVICE, "--requests", str(P15_LOAD["requests"]),
         "--threads", str(P15_LOAD["threads"])], assets=(mdir, paths))
    torch.cuda.synchronize()
    launches = (attn.masked_attention.launches,
                attn.masked_attention.dropout_launches,
                attn.plain_attention.calls)
    per_forward = cfg.half_layers * 3
    forwards = res["batched"]["batches"] + res["unbatched"]["batches"]
    for mode in ("batched", "unbatched"):
        r = res[mode]
        log(f"  {mode}: {r['requests']} requests, {r['errors']} errors, "
            f"{r['rps']} requests/s, p50 {r['p50_ms']} ms, p99 "
            f"{r['p99_ms']} ms, {r['batches']} batches, max batch "
            f"{r['max_batch_seen']}")
    same = res["batched"]["answers"] == res["unbatched"]["answers"]
    log(f"  launches {launches} over {forwards} batched forwards and the "
        f"warm-ups; the first {P15_LOAD['checked']} answers "
        f"{'equal' if same else 'differ'} in both modes")
    if (any(res[m]["errors"] for m in res)
            or res["batched"]["max_batch_seen"] <= 1
            or launches[1:] != (0, 0) or launches[0] % per_forward
            or launches[0] < per_forward * forwards):
        raise AssertionError(f"load test: {res}, launches {launches}")
    answers = phase15_answers(torch, res, mdir, paths)
    return {**{m: {k: v for k, v in r.items() if k != "answers"}
               for m, r in res.items()}, "answers": answers}


def phase15_answers(torch, res, mdir, paths):
    """The load test's first answers against direct forwards of their
    request at the two batch sizes the server ran (16 padded, and 1): each
    served token is its own batch size's argmax wherever that position's
    top-2 gap exceeds one bf16 ulp (phase 10 B's rule), and the two modes
    agree wherever both gaps exceed twice the position's largest |logit
    difference| between the batch sizes (bf16 GEMMs of other shapes round
    differently; phase 10 B's rule for the kernel and the plain path)."""
    from mvp_pytorch_tpu_torch.data.tensorize import collate
    from mvp_pytorch_tpu_torch.pipeline import MODEL_INPUTS
    from mvp_pytorch_tpu_torch.tasks import serve
    from mvp_pytorch_tpu_torch.tools import load_test_serve as lt
    from mvp_pytorch_tpu_torch.training.loop import batch_on
    pipes, _ = serve.build_pipelines(lt.serving_args(mdir, paths, DEVICE))
    pipe = pipes["mlm"]

    def logits(ex, b):
        x = batch_on(DEVICE, collate([ex] * b), MODEL_INPUTS)
        with torch.no_grad():
            out = pipe.model(*(x[k] for k in MODEL_INPUTS),
                             max_tag_length=pipe.tcfg.max_tag_length)
        return out[0].float()
    decided = undecided = 0
    sizes = {"batched": SERVE_MAX_BATCH, "unbatched": 1}
    for i in range(P15_LOAD["checked"]):
        ex = pipe.prepare_example(lt.request_image(i), lt.TEXT)
        pos = np.nonzero(ex["input_ids_a"] == pipe.mask_id)[0]
        lg = {m: logits(ex, b) for m, b in sizes.items()}
        served = {m: mlm_tokens(res[m]["answers"][i]) for m in sizes}
        for j, q in enumerate(pos):
            gap, tok = {}, {}
            for m in sizes:
                top2 = lg[m][q].topk(2).values.tolist()
                gap[m] = top2[0] - top2[1]
                tok[m] = pipe.tokenizer.convert_ids_to_tokens(
                    [int(lg[m][q].argmax())])[0]
                if gap[m] > bf16_ulp(top2[0]) and served[m][j] != tok[m]:
                    raise AssertionError(
                        f"request {i} {m}: served {served[m][j]!r}, its "
                        f"batch size's argmax {tok[m]!r} (gap {gap[m]:.3e})")
            diff = float((lg["batched"][q] - lg["unbatched"][q]).abs().max())
            if min(gap.values()) > 2 * diff:
                decided += 1
                if served["batched"][j] != served["unbatched"][j]:
                    raise AssertionError(
                        f"request {i}: batched {served['batched'][j]!r}, "
                        f"unbatched {served['unbatched'][j]!r} at gaps "
                        f"{gap} over a batch-size difference {diff:.3e}")
            else:
                undecided += 1
            if i < 8:
                log(f"    {lt.request_image(i)} [MASK] {q}: batched "
                    f"{served['batched'][j]!r} (gap {gap['batched']:.4f}), "
                    f"unbatched {served['unbatched'][j]!r} (gap "
                    f"{gap['unbatched']:.4f}); max |logit B 16 - B 1| "
                    f"{diff:.4f}")
    log(f"  answers: {decided} positions decided at both batch sizes, all "
        f"equal; {undecided} within the batch sizes' rounding")
    if not decided:
        raise AssertionError("no answer is decided at both batch sizes")
    return dict(decided=decided, undecided=undecided)


def phase15(torch, attn):
    """Phase 15 on a root like phase 7's (deleted at the end)."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase15")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root)
        log(f"  root: {CLI_IMAGES} images x {CLI_CAPS} captions "
            f"({tsv_bytes / 1e6:.1f} MB of TSV) written in "
            f"{time.perf_counter() - t0:.1f} s")
        data = ["--captions_json", paths["captions"],
                "--feature_tsv", paths["features"],
                "--id2phrase", paths["id2phrase"]]
        res = {}
        t0 = time.perf_counter()
        log("  (A) the trace window")
        res["trace"] = phase15_trace(torch, attn, paths, root, data)
        res["trace"]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log("  (B) the async checkpoint")
        res["async_ckpt"], n_params = phase15_async(
            torch, attn, paths, root, data, res["trace"].pop("ckpt"))
        res["async_ckpt"]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log("  (C) the preemption checkpoint")
        res["preempt"] = phase15_preempt(torch, attn, paths, root, data,
                                         n_params)
        res["preempt"]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log("  (D) the load test")
        res["load_test"] = phase15_load_test(torch, attn, root)
        res["load_test"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 16: the release tools: the parity runbook over a seeded MVPTR-base
# checkpoint in the reference's layout, and the corpus-scale ingest
# rehearsal onto the card
# ---------------------------------------------------------------------------

P16_IMAGES = 100                     # the runbook's eval root, CLI_CAPS captions each
P16_SHIFT = 30.0                     # points added to one expected metric
P16_SHIFTED = "fine_t2i_retrieval_R@5"
P16_EVAL_TIMEOUT_S = 300             # each runbook eval subprocess
P16_INGEST = dict(gb=2.0, chunks=4, workers=4, steps=40)   # B TRAIN_B
# the eval's one shape the earlier phases do not time: the image encoder's
# batch of all P16_IMAGES images (its text batch and its rerank batches are
# phase 3's B 500 L 75 and B 1000 L 125)
P16_TIMED = (("vis", P16_IMAGES, LENGTHS["vis"], "bfloat16", (0.0,),
              "key"),)
P16_INGEST_TIMEOUT_S = 300


def eval_log_counts(out):
    """(kernel launches, plain calls) from the `eval attention:` line of a
    retrieval eval's log.txt."""
    with open(os.path.join(out, "eval", "log.txt")) as f:
        line = [ln for ln in f if "eval attention:" in ln][-1]
    words = dict(w.split("=") for w in line.split() if "=" in w)
    return int(words["launches"]), int(words["calls"])


def phase16_runbook(torch, attn, root):
    """(A) `tools.parity_runbook` over a seeded MVPTR-base `RetrievalModel`
    checkpoint (pytorch_model.bin, config.json, vocab.txt) on a generated
    eval root at the bench geometry: without --expected (exit 0), with its
    own metrics expected (exit 0), with one metric P16_SHIFT points off (exit
    1). Each eval launches the kernel as phase 7's formula says and the
    plain attention never; its R@K equal, in all three runs, the retrieval
    driver's eval-only run in this process on the same flags."""
    import shutil
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tools import parity_runbook as runbook
    t0 = time.perf_counter()
    paths, _, tsv_bytes = write_cli_root(os.path.join(root, "eval_root"),
                                         n_images=P16_IMAGES)
    cfg = base_config(ModelConfig, "float32", dropout=0.1)
    model = RetrievalModel(cfg, device=DEVICE, seed=16)
    ckpt = os.path.join(root, "reference_ckpt")
    cfg.save_pretrained(ckpt)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(ckpt, "pytorch_model.bin"))
    shutil.copy(paths["vocab"], ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    log(f"  reference checkpoint: MVPTR-base RetrievalModel, "
        f"{n_params:,} seeded fp32 parameters, hidden {cfg.hidden_size}, "
        f"{cfg.half_layers}+{cfg.half_layers}+{cfg.half_layers} layers, "
        f"{cfg.vocab_size:,} rows; eval root {P16_IMAGES} images x "
        f"{CLI_CAPS} captions ({tsv_bytes / 1e6:.1f} MB of TSV); "
        f"{time.perf_counter() - t0:.1f} s")
    ek = dict(zip(CLI_EVAL_ARGS[::2], CLI_EVAL_ARGS[1::2]))
    extra = CLI_ARGS + [a for k, v in ek.items() if k != "--eval_batch_size"
                        for a in (k, v)] + CLI_PLATFORM
    argv = ["--reference_ckpt", ckpt, "--feature_tsv", paths["features"],
            "--captions_json", paths["captions"], "--id2phrase",
            paths["id2phrase"], "--num_captions_per_img", str(CLI_CAPS),
            "--eval_batch_size", ek["--eval_batch_size"],
            "--extra_eval_args", " ".join(extra)]
    n_cap, eb, rb = (P16_IMAGES * CLI_CAPS, int(ek["--eval_batch_size"]),
                     int(ek["--rerank_batch_size"]))
    n_pairs = (P16_IMAGES * int(ek["--num_captions_per_img_val"])
               + n_cap * int(ek["--num_images_per_cap_val"]))
    want = cfg.half_layers * (math.ceil(n_cap / eb)
                              + math.ceil(P16_IMAGES / eb)
                              + math.ceil(n_pairs / rb))
    runs = []
    for i, what in enumerate(("no --expected", "its own metrics",
                              f"{P16_SHIFTED} + {P16_SHIFT:g}")):
        out = os.path.join(root, f"run{i}")
        expect = []
        if i:
            exp = {k: 100.0 * v for k, v in
                   runbook.flatten_metrics(runs[0]["metrics"]).items()}
            if i == 2:
                exp[P16_SHIFTED] += P16_SHIFT
            expect = ["--expected", json.dumps(exp)]
        t0 = time.perf_counter()
        rc = runbook.main(argv + ["--out", out] + expect,
                          timeout=P16_EVAL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "eval", "test_eval.json")) as f:
            metrics = json.load(f)
        launches, plain = eval_log_counts(out)
        runs.append(dict(rc=rc, wall_s=wall, launches=launches, plain=plain,
                         metrics=metrics))
        log(f"  runbook with {what}: exit {rc}, {wall:.1f} s wall (the eval "
            f"subprocess included); eval launches {launches} (want {want}), "
            f"plain calls {plain}")
        if (rc, launches, plain) != ((0, 0, 1)[i], want, 0):
            raise AssertionError(f"runbook run {i}: exit {rc}, launches "
                                 f"{launches}, plain {plain}; want exit "
                                 f"{(0, 0, 1)[i]}, {want}, 0")
    flat = runbook.flatten_metrics(runs[0]["metrics"])
    log("  metrics " + " ".join(f"{k}={v:.4f}" for k, v in flat.items()))
    if (len(flat) != 12 or not all(0.0 <= v <= 1.0 for v in flat.values())
            or any(r["metrics"] != runs[0]["metrics"] for r in runs)):
        raise AssertionError(f"runbook metrics malformed or not repeated: "
                             f"{[r['metrics'] for r in runs]}")
    # the reference: the driver's eval in this process, on the same flags
    eval_args = runbook.eval_command(runbook.get_args(
        argv + ["--out", os.path.join(root, "in_process")]))[3:]
    reset_counts(attn)
    t0 = time.perf_counter()
    res = ret.main(eval_args)["eval"]
    torch.cuda.synchronize()
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    same = {k: res[k] for k in ("coarse", "fine")} == runs[0]["metrics"]
    log(f"  the driver's eval in this process: {time.perf_counter() - t0:.1f}"
        f" s, launches {got} (want ({want}, 0, 0)), R@K "
        f"{'equal' if same else 'DIFFER'}")
    if not same or got != (want, 0, 0):
        raise AssertionError("the runbook's eval differs from the driver's "
                             "eval in this process")
    del res
    times = attention_times(torch, attn, P16_TIMED, seed=16)
    for k, row in times.items():
        log(f"  kernel at {k}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f},"
            f" SDPA {row['sdpa_ms']:.4f}, bound {row['bound_ms']:.4f} by "
            f"{row['bound_by']}), max abs err {row['max_abs_err']:.2e}")
    return dict(images=P16_IMAGES, captions=n_cap, pairs=n_pairs,
                params=n_params, launches=runs[0]["launches"],
                eval_wall_s=[r["wall_s"] for r in runs],
                exits=[r["rc"] for r in runs], metrics=flat,
                attention=times)


def phase16_ingest(demand, demand_from, root):
    """(B) `tools.scale_ingest` as a subprocess onto the card at
    P16_INGEST: its four checks, and more bytes streamed than its memory
    bound."""
    flags = ["--root", os.path.join(root, "ingest")]
    for k, v in dict(P16_INGEST, batch=TRAIN_B).items():
        flags += [f"--{k}", str(v)]
    if demand is not None:
        flags += ["--device_demand_ex_s", f"{demand:.1f}"]
    if DEVICE == "cpu":
        flags += ["--platform", "cpu"]
    log(f"  demand: {demand if demand is None else f'{demand:.1f}'} ex/s "
        f"({demand_from})")
    log("  python -m mvp_pytorch_tpu_torch.tools.scale_ingest "
        + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                   for a in flags))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.scale_ingest"]
        + flags, cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=P16_INGEST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"scale_ingest exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    gen, res = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
    log(f"  generated {gen['generated']} GB ({gen['n_images']:,} images, "
        f"{P16_INGEST['chunks']} chunks) in {gen['gen_s']} s; "
        f"{wall:.1f} s wall in all")
    log(f"  ingest_ex_s {res['ingest_ex_s']}  feed_ratio {res['feed_ratio']}"
        f"  rss_growth_mb {res['rss_growth_mb']} (bound "
        f"{res['rss_bound_mb']}: slots {res['slot_mb']} + 400)  streamed_gb "
        f"{res['streamed_gb']}  resume_bit_exact_steps "
        f"{res['resume_bit_exact_steps']}  device {res['device']}")
    if (res["resume_bit_exact_steps"] != 4
            or res["streamed_gb"] * 1024 <= res["rss_bound_mb"]
            or not res["device"].startswith(DEVICE)
            or (demand is None) != (res["feed_ratio"] is None)):
        raise AssertionError(f"scale_ingest result: {res}")
    return dict(gen, wall_s=wall, demand_from=demand_from, **res)


def phase16(torch, attn, demand=None, demand_from="none given"):
    """Phase 16 under _smoke/phase16 (deleted at the end)."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase16")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    try:
        t0 = time.perf_counter()
        log("  (A) the parity runbook")
        res["runbook"] = phase16_runbook(torch, attn, root)
        res["runbook"]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log("  (B) the scale-ingest rehearsal")
        res["ingest"] = phase16_ingest(demand, demand_from, root)
        res["ingest"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 took {res['seconds']:.1f} s")
    return res


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", choices=("bfloat16", "float32"),
                        help="run phase 3 alone, in this dtype")
    parser.add_argument("--cli", action="store_true",
                        help="run phase 7 (the retrieval command line) alone")
    parser.add_argument("--pretrain_cli", action="store_true",
                        help="run phase 8 (the pretraining command line) "
                             "alone")
    parser.add_argument("--finetune_cli", action="store_true",
                        help="run phase 9 (the VQA, SNLI-VE and RE command "
                             "lines) alone")
    parser.add_argument("--nlvr_cli", action="store_true",
                        help="run phase 10 A (the NLVR2 command line) alone")
    parser.add_argument("--serve", action="store_true",
                        help="run phase 10 B (the HTTP server) alone")
    parser.add_argument("--single_stream", action="store_true",
                        help="run phase 11 (the single-stream model and the "
                             "pretraining modes) alone")
    parser.add_argument("--captioning", action="store_true",
                        help="run phase 12 (captioning: training, decoding "
                             "and the eval) alone")
    parser.add_argument("--detection", action="store_true",
                        help="run phase 13 A and B (the detector at full "
                             "width and its training) alone")
    parser.add_argument("--scst_cbs", action="store_true",
                        help="run phase 13 C-E (image to constrained "
                             "caption, CBS and SCST timed) alone")
    parser.add_argument("--parallel", action="store_true",
                        help="run phase 14 (parallelism: MoE at full width, "
                             "the parallel steps at world size 1, the "
                             "streaming coarse stage, sharded checkpoints) "
                             "alone")
    parser.add_argument("--tooling", action="store_true",
                        help="run phase 15 (the trace window, the async and "
                             "the preemption checkpoints, inspect_ckpt and "
                             "the load test) alone")
    parser.add_argument("--runbook_ingest", action="store_true",
                        help="run phase 16 (the parity runbook and the "
                             "scale-ingest rehearsal) alone")
    parser.add_argument("--device_demand_ex_s", type=float, default=None,
                        help="phase 16 B's device demand in examples/s when "
                             "phase 8 does not run in this invocation")
    parser.add_argument("--serve_clients", nargs=3,
                        metavar=("URL", "JOBS", "OUT"),
                        help="the client process of phase 10 B, which the "
                             "script starts itself")
    args = parser.parse_args(argv)
    if args.serve_clients:
        return serve_clients(*args.serve_clients)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.models import layers as layers_mod
    from mvp_pytorch_tpu_torch.ops import _kernels
    from mvp_pytorch_tpu_torch.ops import attention as attn
    from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    log(f"  built {os.path.relpath(lib_path, root)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.sweep:
        log(f"phase 3 alone: two-stage retrieval scoring, {args.sweep}, "
            f"package at {root}")
        sweep = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                                 two_stage_scoring, args.sweep,
                                 reps=2 if args.sweep == "bfloat16" else 1)
        print(json.dumps({"sweep": args.sweep, "card": card, **sweep}),
              flush=True)
        return 0
    if args.cli:
        log("phase 7 alone: the retrieval command line, MVPTR-base, B 96")
        cli = phase7_cli(torch, attn)
        print(json.dumps({"cli": cli, "card": card}), flush=True)
        return 0
    if args.pretrain_cli:
        log("phase 8 alone: the pretraining command line, MVPTR-base, B 96")
        pcli = phase8_pretrain_cli(torch, attn, layers_mod)
        print(json.dumps({"pretrain_cli": pcli, "card": card}), flush=True)
        return 0
    if args.finetune_cli:
        log("phase 9 alone: the VQA, SNLI-VE and RE command lines, "
            "MVPTR-base")
        ft = phase9_finetune_cli(torch, attn, layers_mod)
        print(json.dumps({"finetune": finetune_summary(ft), "card": card}),
              flush=True)
        return 0
    if args.single_stream:
        log("phase 11 alone: the single-stream model, MVPTR-base, B 96, "
            "L 145")
        p11 = phase11(torch, attn, layers_mod)
        print(json.dumps({"single_stream": single_stream_summary(p11),
                          "card": card}), flush=True)
        return 0
    if args.captioning:
        log("phase 12 alone: captioning, MVPTR-base, B 64, L 105; decoding "
            f"{CAP_IMAGES} images")
        p12 = phase12(torch, attn, layers_mod)
        print(json.dumps({"captioning": captioning_summary(p12),
                          "card": card}), flush=True)
        return 0
    if args.detection or args.scst_cbs:
        parts = tuple(p for p, on in (("detection", args.detection),
                                      ("scst_cbs", args.scst_cbs)) if on)
        log(f"phase 13 alone: {', '.join(parts)}")
        p13 = phase13(torch, attn, layers_mod, parts=parts)
        print(json.dumps({"detector": p13.get("detector"),
                          "detector_train": p13["train"],
                          "cbs_scst": cbs_scst_summary(p13),
                          "card": card}), flush=True)
        return 0
    if args.parallel:
        log("phase 14 alone: parallelism on torch.distributed, MVPTR-base")
        p14 = phase14(torch, attn, layers_mod, ModelConfig, RetrievalModel)
        print(json.dumps({"parallel": parallel_summary(p14),
                          "parallel_attention": p14["gpipe_attention"],
                          "card": card}), flush=True)
        return 0
    if args.tooling:
        log("phase 15 alone: the tooling around the training loop, "
            "MVPTR-base")
        p15 = phase15(torch, attn)
        print(json.dumps({"tooling": p15, "card": card}), flush=True)
        return 0
    if args.runbook_ingest:
        log("phase 16 alone: the parity runbook at MVPTR-base and the "
            "scale-ingest rehearsal onto the card")
        p16 = phase16(torch, attn, args.device_demand_ex_s,
                      "the --device_demand_ex_s flag"
                      if args.device_demand_ex_s is not None
                      else "none given: feed_ratio null")
        print(json.dumps({"runbook_ingest": p16, "card": card}), flush=True)
        return 0
    if args.nlvr_cli or args.serve:
        part = "nlvr" if args.nlvr_cli else "serve"
        log(f"phase 10 alone: {part}, MVPTR-base")
        res = phase10(torch, attn, layers_mod, parts=(part,))
        print(json.dumps({part: res[part], "card": card}), flush=True)
        return 0
    phase1_kernel_report(torch, attn, _kernels, lib_path)
    torch.cuda.synchronize()

    log("phase 2: kernel against plain version")
    errors, timings = phase2_kernel_vs_plain(torch, attn)
    torch.cuda.synchronize()
    log("phase 2: attention backward against plain autograd, training shapes")
    bwd_timings = phase2_backward(torch, attn)
    torch.cuda.synchronize()
    log("phase 2: attention-prob dropout inside the kernel")
    drop_timings = phase2_dropout(torch, attn)
    torch.cuda.synchronize()
    log("phase 2: the kernel at NLVR2's shapes (fused L 140 on the online "
        "kernels; the vision stream L 70)")
    nlvr_times = attention_times(torch, attn, NLVR_TIMED, seed=10)
    torch.cuda.synchronize()

    log("phase 3: two-stage retrieval scoring, MVPTR-base, bench geometry")
    sweep = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                             two_stage_scoring, "bfloat16", reps=2)
    sweep32 = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                               two_stage_scoring, "float32", reps=1)
    torch.cuda.synchronize()

    log("phase 4: kernel path against plain path, end to end")
    phase4_end_to_end(torch, attn, layers_mod, ModelConfig, RetrievalModel)
    torch.cuda.synchronize()

    log("phase 5: retrieval training step, MVPTR-base, batch 96")
    train = phase5_training(torch, attn, layers_mod, ModelConfig,
                            RetrievalModel)
    torch.cuda.synchronize()

    log("phase 6: pretraining step, MVPTR-base, batch 96, dropouts 0.1")
    pre = phase6_pretraining(torch, attn, layers_mod, ModelConfig)
    torch.cuda.synchronize()

    log("phase 7: the retrieval command line, MVPTR-base, B 96, generated "
        "root")
    cli = phase7_cli(torch, attn, sweep["pairs_per_s"][-1])
    torch.cuda.synchronize()

    log("phase 8: the pretraining command line, MVPTR-base, B 96, generated "
        "corpus")
    pcli = phase8_pretrain_cli(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 9: the VQA, SNLI-VE and RE command lines, MVPTR-base, "
        "generated root")
    ft = phase9_finetune_cli(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 10: NLVR2 through its command line and the HTTP server, "
        "MVPTR-base, generated root")
    p10 = phase10(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 11: the single-stream model (L 145), its pretraining modes "
        "through the command line and its classifier, MVPTR-base, generated "
        "corpus")
    p11 = phase11(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 12: captioning (L 105) through its command line, greedy and "
        "beam decoding, cached and recomputed, and its eval, MVPTR-base, "
        "generated root")
    p12 = phase12(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 13: the detector at full width and its training, image to "
        "features to constrained caption through the captioning command "
        "line, CBS and SCST timed, MVPTR-base")
    p13 = phase13(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 14: parallelism on torch.distributed: MoE pretraining at "
        "full width, the parallel steps at world size 1 over NCCL, the "
        "streaming coarse stage at corpus scale, sharded checkpoints")
    p14 = phase14(torch, attn, layers_mod, ModelConfig, RetrievalModel, pcli)
    torch.cuda.synchronize()

    log("phase 15: the tooling around the training loop: a trace window, "
        "the async and the preemption checkpoints, inspect_ckpt and the "
        "load test, MVPTR-base")
    p15 = phase15(torch, attn)
    torch.cuda.synchronize()

    log("phase 16: the parity runbook over a seeded MVPTR-base checkpoint in "
        "the reference's layout, and the scale-ingest rehearsal onto the card")
    p16 = phase16(torch, attn, pcli["samples_per_s"],
                  "phase 8's pretraining CLI samples/s in this run")
    torch.cuda.synchronize()

    main_t = timings[("fused", "bfloat16")]
    main_err = errors[("fused 2-D padded keys", 1000, "bfloat16", "blhd")]
    train_t = bwd_timings[("fused", "bfloat16")]
    t32 = timings[("fused", "float32")]
    train32 = bwd_timings[("fused", "float32")]
    drop_t = drop_timings[("fused", "bfloat16")]
    drop32 = drop_timings[("fused", "float32")]
    kernels = {"kernels": [{
        "name": "masked_attention_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": sweep["launches"], "max_abs_err": main_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "training": {
            "launches": train["launches"],
            "launches_per_step": train["launches_per_step"],
            "shape": f"B {TRAIN_B} L 125 bf16 blhd",
            "fwd_ms": train_t["fwd_ms"],
            "fwd_plain_ms": train_t["plain_fwd_ms"],
            "fwd_bound_ms": train_t["fwd_bound_ms"],
            "bwd_ms": train_t["bwd_ms"],
            "bwd_plain_ms": train_t["plain_bwd_ms"],
            "bwd_bound_ms": train_t["bwd_bound_ms"],
            "bwd_bound_by": train_t["bwd_bound_by"],
            "bwd_max_abs_err": train_t["grad_err"],
            "sdpa_fwd_ms": train_t["sdpa_fwd_ms"],
            "sdpa_fwd_bwd_ms": train_t["sdpa_fwd_bwd_ms"],
            "step_ms": train["step_ms"],
            "samples_per_s": train["samples_per_s"],
            "peak_gb": train["peak_gb"]},
        "pretraining": {
            "launches": pre["launches"],
            "launches_per_step": pre["launches_per_step"],
            "dropout_launches_per_step": pre["launches_per_step"],
            "step_ms": pre["step_ms"],
            "samples_per_s": pre["samples_per_s"],
            "peak_gb": pre["peak_gb"],
            "dropout_shape": f"B {TRAIN_B} L 125 bf16 blhd p {DROP_P}",
            "dropout_ms": drop_t["ms"], "p0_ms": drop_t["p0_ms"],
            "dropout_plain_ms": drop_t["plain_ms"],
            "dropout_max_abs_err": drop_t["max_abs_err"],
            "dropout_bound_ms": drop_t["bound_ms"],
            "dropout_bound_by": drop_t["bound_by"],
            "sdpa_dropout_ms": drop_t["sdpa_ms"],
            "dropout_bwd_ms": drop_t["bwd_ms"],
            "p0_bwd_ms": drop_t["bwd_p0_ms"],
            "seconds": pre["seconds"]},
        "cli": {k: v for k, v in cli.items() if k != "losses"},
        "pretrain_cli": pcli,
        "finetune": finetune_summary(ft),
        "nlvr": {**{k: v for k, v in p10["nlvr"].items()
                    if k not in ("losses", "mem_losses")},
                 "attention": {k: v for k, v in nlvr_times.items()
                               if not k.endswith("fp32")}},
        "serving": p10["serve"],
        "single_stream": single_stream_summary(p11),
        "captioning": captioning_summary(p12),
        "cbs_scst": cbs_scst_summary(p13),
        "parallel": parallel_summary(p14)}, {
        # the fp32 kernels (3xTF32) behind the same entry point; launches
        # and pairs/s from the fp32 sweep of phase 3
        "name": "masked_attention_fwd fp32 (3xTF32)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": sweep32["launches"],
        "max_abs_err": errors[("fused 2-D padded keys", 1000, "float32",
                               "blhd")],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"],
        "sweep_pairs_per_s": sweep32["pairs_per_s"][0],
        "sweep_peak_gb": sweep32["peak_gb"],
        "training": {
            "shape": f"B {TRAIN_B} L 125 fp32 blhd",
            "fwd_ms": train32["fwd_ms"],
            "fwd_plain_ms": train32["plain_fwd_ms"],
            "fwd_bound_ms": train32["fwd_bound_ms"],
            "fwd_bound_by": train32["fwd_bound_by"],
            "sdpa_fwd_ms": train32["sdpa_fwd_ms"]},
        "dropout": {
            "shape": f"B {TRAIN_B} L 125 fp32 blhd p {DROP_P}",
            "ms": drop32["ms"], "p0_ms": drop32["p0_ms"],
            "plain_ms": drop32["plain_ms"],
            "max_abs_err": drop32["max_abs_err"],
            "bound_ms": drop32["bound_ms"], "bound_by": drop32["bound_by"],
            "sdpa_ms": drop32["sdpa_ms"]},
        "nlvr_attention": {k: v for k, v in nlvr_times.items()
                           if k.endswith("fp32")},
        "single_stream_attention": {
            k: v for k, v in p11["kernel"]["times"].items()
            if k.endswith("fp32")},
        "captioning_attention": {
            k: v for k, v in p12["kernel"]["times"].items()
            if k.endswith("fp32")},
        "cbs_scst_attention": {
            k: v for k, v in p13["kernel"].items() if k.endswith("fp32")},
        "gpipe_attention": p14["gpipe_attention"]}]}
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"detector": p13["detector"],
                      "detector_train": p13["train"], "card": card}),
          flush=True)
    print(json.dumps({"tooling": p15, "card": card}), flush=True)
    print(json.dumps({"runbook_ingest": p16, "card": card}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
