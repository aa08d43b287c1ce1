"""Smoke run of the PyTorch + CUDA port (howl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR | --profile-only DIR]
    python3 chip_smoke.py --train-repeat    (phase 17's short training alone)
    python3 chip_smoke.py --trace-batch WS DIR    (phase 17f (a)'s traced batch alone)

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them. In order it:

  1. prints the card's ``nvidia-smi`` name and power limit;
  2. builds the hand-written kernels from ``howl_tpu_torch/csrc`` (one nvcc
     per source, all at once, sm_90a) and prints the build time;
  3. holds both log-mel frontend kernels, the tensor-core one ("tc",
     ``csrc/frontend_tc.cu``: the three bf16 grades and the exact grade
     "f32" as six bf16 passes) and the float32-FMA one ("fma",
     ``csrc/frontend.cu``: every grade), against their plain PyTorch
     version at the serving path's shape, B=512 x 128,000 samples, 40 mels,
     in every precision grade with float32 and bf16 output (the three-pass
     grade "bf16x3", the JAX kernel's default, and "f32" on both kernels),
     plus six "fm" cases (the per-window scorer's layout); then times the
     main path's case in turns (plain, fma, tc, tc, fma, plain), the two-pass
     grade (fma, tc, tc, fma), the three-pass grade and the exact grade
     (plain, fma, tc, tc, fma, plain each), each with its bound ("f32" also
     with the six-pass bound); the tensor-core kernel must be the faster at
     "bf16", "bf16x3" and "f32". Before that it counts the tensor-core and
     bulk-copy opcodes in the built library: the tensor-core frontend kernel,
     the stem fold kernel (T2), the trunk proto (T1) and the frontend study's
     GEMM (M2) and polyphase kernel (M3) must hold HGMMA (``wgmma``) and
     UBLKCP (bulk copies), M3 no HMMA, the tensor-core stem kernel HMMA or
     HGMMA;
  4. holds both res8 stem kernels, the tensor-core one ("tc",
     ``csrc/stem_tc.cu``: bf16) and the float32-FMA one ("fma",
     ``csrc/stem.cu``: bf16 and float32), against their plain version on
     (512, 641, 40) mels, then times them in turns (plain, fma, tc, tc, fma,
     plain); the tensor-core kernel must be the faster;
  5. holds the noise-bank mix kernel against its plain version, bit for
     bit, at the train step's shape (1024 x 8,000 samples from a (512,
     32,000) bank, draws from the step's own sampler), on a narrow bank of
     width 5,000 (sample-exact starts) and at a ragged window of 7,919;
  6. drives the trunk-kernel study
     (``howl_tpu_torch.tools.bench_trunk_kernel_micro``) at 512 x 8 s in
     bf16 and prints its seven legs' times; the trunk proto (T1) and stem
     fold (T2) kernels' launch counts are zeroed just before and read just
     after, and both must have grown. Then it holds T1 (``wgmma`` on slot
     rows, each layer's weights by a bulk copy), both variants, and T2
     (``wgmma`` on a resident, swizzled image of W), bf16 and float32 output,
     against their plain versions on the study's inputs and times T2 alone;
  7. drives the frontend cost study
     (``howl_tpu_torch.tools.bench_pallas_micro``) at 512 x 8 s and prints
     its six legs and three library legs; the stream (M1), GEMM (M2) and
     polyphase (M3) kernels' launch counts are zeroed just before and read
     just after, and each must have grown; three products must take over
     1.5 times one product's time, since two of them are thrown away and a
     compiler might drop them. Then it holds M1 (bit for bit),
     M2 (``wgmma``, W and x by bulk copies) and M3 (``wgmma`` on hop rows
     read by descriptor, W and H by bulk copies; one and three products)
     against their plain versions on the
     study's inputs with a nonzero scalar, and runs
     ``howl_tpu_torch.tools.validate_pallas_precision``: the frontend kernel
     at every grade against the float64 goldens, the "f32" grade inside the
     golden tests' bounds and "bf16x3" (on "tc" at 40 mels) inside the JAX
     kernel's three-pass tiers;
  8. drives the device-memory bandwidth sweep
     (``howl_tpu_torch.tools.bench_hbm_sweep``) at 256 MB, 8 and 32
     iterations, the full list, and prints every leg; the seven sweep
     kernels' launch counts (auto read, auto copy, stream repro, manual
     read, manual write, manual copy, whole-array copy) are zeroed just
     before and read just after, and each must equal the launches the sweep
     made; no kernel leg may read over 1.1 x 3.35 TB/s by the bytes its
     definition moves (the slope of two chain times is noisy by a few percent;
     a dropped copy reads a multiple). Then it holds the seven kernels
     against their plain versions, bit for bit over the whole output, with a
     scalar that is no bf16
     number: the block legs and the whole-array copy on the sweep's arrays
     (float32 at block heights 256 and 4096, bf16 at 1024) and on an array of
     3,144 rows; the manual legs at (k, cb) = (2, 512), (3, 1024), (8, 512)
     in float32 and (3, 1024) in bf16, and on 3,144 rows in both dtypes at
     cb = 24 and 1,048, where a bf16 chunk is no whole number of ring stages
     (a float32 chunk always is: 8 rows are one stage); the auto copy at bn
     = 256, the manual copy at (2, 512) and the whole-array copy eight
     launches in a row on eight arrays, all in flight before each output is
     held. A watchdog ends the
     run with an error if the phase hangs;
  9. drives the serving path: ``StreamingEngine.infer_batch`` with a res8
     made from seeded numpy weights, in bf16, on 512 clips of 8 s. The
     frontend and stem kernels' launch counts are zeroed just before and
     read just after; both must have grown, and the frontend's and the
     stem's launch must each be the tensor-core kernel's, one of each per
     batch. Its decisions must equal the
     float32 engine's on the same card (both at the "bf16" frontend grade),
     on a batch where some clips fire and some do not, and a float32 engine
     at the exact grade must decide the same on K1 "tc" (six bf16 passes)
     as with K1 forced to "fma" (``route="fma"``). Then it times chains
     of 32 batches through the bench's ``chained_batch_ms`` (each input
     bumped by the last detections, CUDA events, 2 repeats) and prints the
     median realtime factor;
  9b. holds the float32 paths to their own TF32 setting (ROADMAP F13): with
     the caller's global TF32 flags on and then off, a float32 engine built
     with defaults (the exact "f32" frontend grade, F12) scores 64 clips of
     8 s and the ``OnlineEngine`` and the ``IncrementalOnlineEngine`` take
     one float32 hop at 512 streams; each result must be bit for bit the
     same both times and the flags the caller's again after each call, while
     the same scorer without its guard must differ (the flags reach the card);
 10. drives the per-window mega-batch scorer (``fused_trunk=False``) at the
     same size, 61,952 windows of 41 frames: one bf16 batch between zeroed
     counters must launch the frontend kernel and the tensor-core stem
     kernel once each; its posteriors must be (512, 121, 4), finite and sum
     to 1; its decisions must equal the exact float32 scorer's on a batch
     where some clips fire and some do not. The stem kernel is held against
     its plain version on that window batch, chunk by chunk;
 10b. drives the JAX serving headline's precision ladder at the same size
     in bf16: K1 "tc" at "bf16", K2 "tc", the int8 residual trunk (the fused
     kernel ``csrc/int8_trunk_fused.cu``, the route the engine takes at this
     geometry) calibrated on the batch's first 64 clips as the bench builds
     it. One batch between zeroed counters must launch K1 "tc", K2 "tc" and
     the fused trunk once each and the int8 layer kernel never; its
     posteriors must be finite and sum to 1; the fused trunk must equal the
     plain int8 trunk bit for bit on the batch's stem and on 1 and 3 clips of
     1, tile - 1, tile, tile + 1 and 213 frames at 10 and 8 bins, in bf16
     (tiles of 43 frames) and float32 (24); the layer kernel
     (``route="layer"``, ``csrc/int8_trunk.cu``, six launches) too, its
     first layer's s32 sums exact through its interface; the engine's
     decisions must equal an engine's on the plain int8 trunk; it prints the
     share of decisions that agree with the exact float32 engine (random
     weights), times the two routes and cuDNN's bf16 stage 3 in turns
     (fused, layer, cuDNN, layer, fused) with their bounds, and runs the
     full-step A/B of the bf16 trunk against the int8 trunk on each route
     (``ablate_serving_slope.trunk_ab``: two-point slopes in turns) that
     decided the bench's headline trunk;
 10c. runs both int8 tools at their JAX tools' sizes
     (``howl_tpu_torch.tools.bench_trunk_int8`` at batch 512, three legs: cuDNN's
     bf16 stack, the int8 trunk on its fused route, the layer kernel's conv rate;
     ``howl_tpu_torch.tools.bench_stream_step_int8`` at (16,384, 1) and
     (65,536, 3), two legs each, chains of 8 and 32 steps); every leg must
     print a positive time;
 11. runs the decision gate ``howl_tpu_torch.tools.validate_tpu_decisions``
     on the card, its float32 oracle's K1 on "tc" at the exact grade (six
     bf16 passes): all fourteen rows must run and be OK, the three-pass
     grade's (``res8+k1[bf16x3]+k2``, on the tensor-core frontend kernel),
     the int8 trunk's (``res8+k1[bf16]+k2+int8``), the three live engines',
     the five other families' rows and lstm's live row
     (``lstm+full-window[bf16]``) included;
 11b. serves the zoo's seven other families offline at their registered
     widths (small-cnn, seq-cnn, mobilenet, lstm, seq-lstm, gru, las), on
     seeded numpy weights carried across by ``compat`` and 512 clips of 8 s
     of the gate's ``family_audio`` (its eight distinct clips, each 64
     times), the weights fixed per family and the word and threshold picked
     from float32 scores by the gate's ``family_setup`` (every decision 0.01
     or more from flipping): ``infer_batch`` in float32 (K1 at "f32") and in
     bf16 (K1 at "bf16"), seq-lstm and seq-cnn through ``WholeClipEngine``,
     lstm and gru once more in bf16 with ``carry_windows``. Between zeroed
     counters each batch must launch K1 once ("tc" where ``frontend_route``
     serves the grade), las's none (its stacked chain); the posteriors must
     be finite and the bf16 decisions equal float32's by the gate's rule.
     It prints each family's batch times, its bf16 realtime factor beside
     the card's name and power limit, and where its recurrences run
     (``recurrence_backend``: cuDNN in float32 and in bf16 on the H100);
 11c. serves the seven families live at their registered widths, 512
     streams of ``family_audio`` (a window and 23 hops): the ``OnlineEngine``
     on its 24 whole windows, the ``IncrementalOnlineEngine`` on every hop
     (not las, which reads delta channels), and lstm, seq-lstm and gru once
     more on the ``OnlineEngine`` with ``carry_hops``; each in float32 (K1 at
     "f32") and in bf16 (K1 at "bf16"), on the weights of ``FAMILY_WEIGHTS``
     (``FAMILY_LIVE_WEIGHTS`` where it has an entry) at the word and
     threshold ``family_live_setup`` picks from the float32 engine's per-hop
     posteriors. Between zeroed counters an ``OnlineEngine`` must launch K1
     once a hop ("tc"), las and the incremental engine never; the bf16 fire
     flags and labels must equal float32's by the gate's live rule. It
     prints each family's hop ms;
 12. drives the live serving path (a): the ``OnlineEngine`` at 512 streams
     in bf16, 16 hops between zeroed counters, which must launch the
     tensor-core frontend kernel and the tensor-core stem kernel once a hop
     each; then holds K1 ("fm", grade "bf16", bf16 out) on the (512, 8,000)
     windows and K2 on their (512, 41, 40) mels against their plain
     versions, in ``check_frontend``'s and ``check_stem``'s bounds, and
     times each against its plain version in turns;
 13. (b) the ``IncrementalOnlineEngine`` at 65,536 streams for 3 hops: the
     tensor-core stem kernel launches once a hop on 65,536 clips, and on the
     last hop's windows it agrees with its plain version chunk by chunk;
 14. (c) each live engine at 512 streams of 63,200 samples whose loud half
     fires, on a word and threshold that leave every decision 0.01 from
     flipping (``live_config``): bf16 labels and fire flags equal float32's
     at every hop, and equal the offline ``StreamingEngine``'s on the same
     streams (the per-window scorer for the ``OnlineEngine`` and the
     incremental engine, the fused scorer on a silent preroll + the hops
     for the trunk engine, per hop and with ``hop_block`` 3, each window
     ``lag`` hops late);
 15. holds one float32 train step with the bank on the card against the
     same step on the CPU (batch 16, the same variables and draws);
 16. drives the training path: ``make_classification_train_step`` at the
     JAX train bench's width (res8 45 maps, batch 1024 x 8,000 samples,
     bf16 compute over float32 masters, VTLP, augmentation, a (512, 32,000)
     noise bank with replace_prob 0.1, AdamW), from seeded numpy variables
     carried across by ``compat``, on tones whose band sets the label. The
     mix kernel's count is zeroed before 30 steps and must equal 30 after;
     the loss must be finite and fall; every parameter, conv0 included,
     must get a nonzero gradient; the BatchNorm running stats must move;
     a float32 step must run and be finite. Then it times the bench's three
     steps (bf16 with and without the bank, float32) in chains of 64, in
     turns, 2 repeats (``bench.time_train_steps``) and prints the medians;
 17. drives the training entry point (``python -m howl_tpu_torch.training.run.train``, called as
     ``train.run``). First (ROADMAP F15) two processes at once (``chip_smoke.py --train-repeat``), each
     in a temporary directory of its own, train one epoch of 10 steps from one seed: their epoch losses
     must be equal, printed. The noise corpus is named by a path that is the same in every process
     (``/proc/self/cwd/noise``), since the entry point splits it by a hash of each clip's absolute path.
     Then on the card at res8's full width,
     ``envs/res8.env``'s recipe (batch 16, LR 0.01, decay
     0.955, weight decay 1e-5, 0.5 s windows, 40 mels, sequence [0, 1, 2]) with the noise corpus on and
     augmentation on, on a tone corpus of 24 positives and 24 negatives and 12 noise clips of 3 s that it
     writes to a temporary directory: 60 epochs of 10 steps, then ``--eval`` on the same workspace, a
     2-epoch ``--resume`` under ``torch.profiler``, and 2 epochs of ``--bf16 --fused-trunk``. Around each
     call the launch counts are zeroed and read: K3 must launch once a train step, K1 and K2 once an
     evaluator batch. Every dev and test positive must fire and no negative; the noisy sweeps must be
     there; ``--eval`` from ``model-best.pt`` must give the run's confusion matrices; ``--resume`` must
     carry the step count and AdamW's state on. F9: on the trained weights the bf16 engine (K1 "tc" at the
     "bf16" grade, K2 "tc") must decide as the float32 engine at the exact grade on every dev and test
     clip. The int8 engine (the same with the int8 trunk, calibrated on the train clips, one launch of the
     fused trunk a batch) must give the plain int8 trunk's posteriors bit for bit and its decisions on the
     same weights and calibration (a check that holds whatever the card's training produced), and the float32
     engine's detections; its first-fire shift against the float32 engine is printed, not gated (ROADMAP
     F14: it measures the weights this run trained). K1 takes "tc" in the float32 evaluator wherever
     ``frontend_route(config, "f32")`` says so. It prints the loop's steps/s and examples/s, the shares of host batch preparation and the train
     step (host timers that wait for the device), the device's busy time a step inside the loop and its
     idle share, the evaluator's realtime factor and the max |dprob| of F9;
 17b. trains each of the seven families through the entry point on the same corpus and recipe with ``--bf16``
     (flax's mixed precision over float32 masters), 30 epochs of 10 steps: seq-cnn and seq-lstm under CTC, the
     others under the frame objective, and small-cnn once more under ``CONVERT_STATIC`` (CTC). K3 must launch once
     a train step, K1 once an evaluator batch (las never), K2 never; F9 on each run's trained weights: the bf16
     engine must detect as the exact float32 engine on every dev and test clip. F9 counts as held for a run only
     where the float32 engine fires on some clips and not on others; a run whose engine decides one way on every
     clip is named "not held", with its largest word posterior. It prints each run's epochs, losses, steps/s and
     the dev positives that fired;
 17c. serves phase 17's trained res8 through the live serving surface: (a) writes it as a port workspace and as a
     reference (castorini/howl) one and serves each through ``hub.load_workspace_engine`` as every engine kind (the
     ``OnlineEngine``, incremental, streaming trunk, ``hop_block`` 3, ``auto``), float32 as the hub builds them, on
     the 24 dev and test clips as streams with 0.5 s of silence after each, fed at the client's cadence: each
     stream's detection must equal the hub's offline engine's (``load_workspace_streaming_engine``, one K1 and one
     K2 launch a batch) on its clip, and between zeroed counters the port workspace's ``OnlineEngine``,
     incremental and trunk engines must launch K1 and K2 as the same engines built directly (K1 and K2 once an
     ``OnlineEngine`` hop, K2 once an incremental hop, K2 once in the trunk's prefill) and fire as they do;
     ``HowlClient`` over two positive and two negative WAVs (each followed by 0.5 s of silence) must detect on
     each as the offline engine decides, for the three per-hop engines; (b) ``MultiStreamServer`` at 512 streams
     on the native mux (which must have built) runs 40 ticks of the incremental engine and prints the ticks'
     mean and p99 ms, underruns, overruns and alarms; (c) runs ``bench_stream_mux``; (d) runs the four live
     tools at 65,536 streams (``bench_streaming_trunk``, ``bench_trunk_blocked``, ``ablate_trunk_step``,
     ``bench_online_dft_precision``: "bf16x3" against "bf16"), every time finite and positive; (e) runs
     ``gen_capacity_table --calibrate 1024,16384,65536 --steps 8`` (server ticks of the push engines) and prints
     the measured points beside the committed profiles' model;
 17d. the config-driven ``Trainer`` and the wake-word experiment harness on phase 17's corpora, res8 in float32:
     (a) a ``TrainingConfig`` of phase 17's recipe, written by ``Workspace.save_config`` and read back equal, trained
     by ``Trainer.train`` with ``--use-timestretch`` (6 epochs of 10 steps): K3 once a step, K1 and K2 once an
     evaluator batch, ``model-best.pt`` and ``training_config.json`` written; (b) ``eval_wake_word_detection.run -n
     2 --sharded-seeds`` (40 epochs of 10 sweep steps): K3 once a sweep step over both seeds' 32 examples, not once a
     seed, K1 and K2 once an evaluator batch of the seeds' threshold sweeps, the seeds' weights different, the clean
     report with a row for every set, threshold and metric and tp + fn the positive set's size at every threshold,
     ``generate_roc.load_metrics`` reading it; each seed's first-step loss equal to its own single-model step's
     within 1e-6 relative; it prints the sweep's steps/s against two single-seed runs on the same batches (in
     turns, after a warm-up pass of each) and the phase's seconds;
 17e. GSC pretraining and the dataset pipeline, in phase 17's working directory (its noise corpus and recipe): (a)
     ``generate_dataset.sh``'s three steps on a Common Voice-layout tone corpus of 72 clips (``write_cv_corpus``:
     "hey fire fox", a longer sentence with it, a sentence with one of its words, one with none): raw mining of
     positives and negatives, stub alignment of both, stitching of the positives (64, 16 and 16 clips, each with its
     three word labels), then res8 trained in float32 through the entry point with ``--use-stitched-datasets`` and the
     noise corpus, 4 epochs of 10 steps: K3 once a step, K1 and K2 once an evaluator batch; (b) ``pretrain_gsc`` on a
     Speech Commands-layout tone corpus of the GSC-10 words (64 clips of 1 s a word, 10 % silence, 12 labels, batch
     64, 40 mels), res8 at 45 maps in float32 for 3 epochs (its loss must fall and its test accuracy beat chance),
     then ``--sharded-seeds 2 --bf16`` (each seed's first sweep step's loss bit for bit its own single-model step's at
     its key on its batch, ``seed_0/`` and ``seed_1/`` written), then ``eval_commands_recognition --models res8 -n 2
     --epochs 2`` (its report written). GSC pretraining launches neither K1 (the plain log-mel chain) nor K3 (no noise
     bank), as in JAX, and K2 once an eval batch (the eval step scores res8 through the stem kernel). It prints the
     stitched counts, steps/s, accuracies, launch counts and the phase's seconds;
 17f. the exports, vision pretraining, the demo, profiling and scale-out on phase 17's trained res8: (a)
     ``utils.profiling.trace`` around one offline bf16 batch of 512 clips in a process of its own (``python3
     chip_smoke.py --trace-batch WS DIR``, where no earlier session drops the first device records: F18, which
     17g holds in this process), whose trace must name K1's and K2's kernels; (b) K1 on the Meyda basis (22,050 Hz,
     f_max 8 kHz, 40 mels, the exact grade) against
     ``MeydaMelSpectrogram`` at rtol 1e-3 / atol 1e-4 in the exp domain; (c) ``export_honkling`` equal to the host's
     dump of the same weights; (d) K2 at 32 mel rows (``check_stem_32``: both routes in bf16 and "fma" in float32
     against ``res8_stem_plain``, bf16 timed in turns at 512 images), then ``pretrain`` on a 512-image
     CIFAR-layout corpus, K2 ("fma") once an eval batch; (e) ``demo --streams 4 --incremental`` (K2 once a tick) and
     the single-stream demo through ``HowlClient`` (K1 and K2 once a hop), their printed lines echoed; (f) the three
     live engines at 512 streams sharded two ways on the one card, each hop's decisions equal to the unsharded
     engine's, K1 and K2 once a hop a shard where the engine launches them; (g) ``train --num-devices 2`` (NCCL)
     against ``--num-devices 1`` where two cards are visible, otherwise a line saying it did not run. It prints the
     phase's seconds;
 17g. the seed sweep on a (seed, data) grid, on phase 17's corpora: ``eval_wake_word_detection.run -n 2
     --sharded-seeds`` (2 epochs of 10 sweep steps) in one process, then through ``run(..., mesh=)`` on a (seed 2,
     data 2) grid of four ranks sharing the card (gloo over CUDA tensors), printing the backend, each rank's K3
     launches (one a sweep step over its rows) and K1 and K2 launches (one an evaluator batch of its seed's threshold
     sweeps), and each seed's losses against the one-process sweep (first step within 1e-5, every epoch within 5e-3
     relative, else the run fails) and whether the reports' counts are equal; on NCCL over four distinct cards where
     four are visible, otherwise a line saying it did not run; then F18's check: after a profiler session of
     60,000 launches, a plain session around 20 K1 launches (the control, its count printed) and two
     ``utils.profiling.trace`` sessions around them, each of which must record all 20. It prints the phase's
     seconds;
 18. K1's frame tiles and the last root tools (``drive_frontend_tiles_and_tools``): (a) every tile K1 is compiled
     for at 40 mels ("tc" 64, 128, 256; "fma" 16, 32, 64), in every grade the instance serves, float32 and bf16
     output, both layouts, bit for bit the route's default tile (128, 32) on 512 clips of 8 s and on 3 clips of
     30,001 samples, and within phase 3's tolerance of the plain version, each instance and grade timed; the split
     grades' 256-frame block and the FMA kernel's three-pass 64-frame block must be refused before any launch;
     (b) the three frontend tools at full size, ``sweep_frontend_blocks`` (every tile at "bf16x2"),
     ``bench_frontend_variants`` and ``bench_frontend_tail_1pass``, K1's launch counters (all, "tc", and each
     instance's) zeroed before each tool and read after, every leg's line echoed; each tool must launch each
     instance it names, and the variants tool must leave TF32 off; (c) ``howl_tpu_torch.bench_train`` at its card
     sizes (batch 128 and 24 steps, batch 1024 for the last line), its three JSON lines echoed, every rate finite
     and positive and every loss finite. It prints the phase's seconds;
 19. (d) runs the bench, ``howl_tpu_torch.bench.main``, which prints its
     JSON line (``bench.py``'s keys, each measured key the median of 5
     repeats with its spread); every measured key must be finite and
     positive, the seven online keys included, each latency at every
     stream count of ``bench.py``, and its ``rungs["int8"]`` must name the
     fused kernel, one launch a batch;
 20. prints one JSON line with each of the seventeen kernels' launches, and of K1's six tile instances at
     40 mels (their launches those of phase 18's tools; K1's also on each family's
     paths of phases 11b and 11c and K1's and K2's on phase 17d's harness, K3's also on each training run of
     phase 17b and on phase 17d's Trainer and seed sweep, K1's, K2's and K3's on phase 17e's stitched training and
     GSC runs, K1's and K2's on phase 17f's demo and sharded engines, K2's on its pretraining with its record at 32
     mel rows, K1's, K2's and K3's on each rank of phase 17g's grid), error and times
     beside its plain version's and its bound on this card (the larger of
     its bytes over 3.35 TB/s and its operations over the peak rate of
     their type, both counted from this run's shapes: what the function
     needs, beside which the two studies' and the sweep's kernels carry a
     staged bound for the work the study defines) and the one PyTorch call of the same function where there is
     one, then the device line last.

``--profile DIR`` adds a stage breakdown and a ``torch.profiler`` kernel
table, with the device's idle share, of the bf16 serving batch through the
fused-trunk scorer (``DIR/serve_profile.txt``; with the int8 trunk
``DIR/serve_int8_profile.txt``) and the per-window scorer
(``DIR/legacy_profile.txt``), of a hop of each live engine at 512 streams
and of the incremental and trunk engines at 65,536
(``DIR/online_*_profile.txt``), of an ``OnlineEngine`` hop of mobilenet and
of lstm at 512 streams in float32 and in bf16
(``DIR/online_<family>_<grade>_profile.txt``), and of the bf16 noise-bank train step
(``DIR/train_profile.txt``). ``--profile-only DIR`` builds the kernels, writes
the two profiles and the device line, and runs none of the checks.

Float32 matrix products and convolutions run in full float32 here (TF32 off)
so the plain versions are float32 references.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from howl_tpu_torch import bench

BATCH = 512
CLIP_SECONDS = 8.0
SAMPLE_RATE = 16000
N_MELS = 40
SEED = 0
# the JAX train bench's configuration (bench.py: bench_train_step)
TRAIN_BATCH = 1024
TRAIN_WINDOW = 8000
BANK_SHAPE = (512, 32000)
REPLACE_PROB = 0.1
TRAIN_STEPS = 30
SMOKE_REPEATS = 2  # chained timings of the main and train paths (the bench's line takes its own five)
STUDY_ITERS = 16  # calls per timed repeat of each leg of the two kernel studies
MICRO_S = 0.25  # the nonzero scalar of the frontend cost study's comparisons
HBM_MB = 256  # the bandwidth sweep's array, the JAX tool's size
HBM_ITERS = 8  # its short chain; the long one is four times as long
HBM_S = 0.3  # the scalar of the sweep's comparisons: no bf16 number, so the bf16 legs must round it first
HBM_ODD_ROWS, HBM_ODD_BN = 3144, 24  # a size that is not the sweep's: 131 blocks, a last stage that is not full
# the manual legs' comparisons: (k, cb) on the float32 array, on the bf16 array, and on the 3,144 rows in both dtypes
# (bf16 chunks of 24 and 1,048 rows are 1.5 and 65.5 ring stages of 16 KB)
HBM_RING_F32, HBM_RING_BF16, HBM_RING_ODD = ((2, 512), (3, 1024), (8, 512)), ((3, 1024),), ((2, 24), (3, 1048))
HBM_REPEATS = 8  # launches in a row of each copy kernel, each held against its plain version
HBM_PHASE_LIMIT_S = 300  # the sweep phase's watchdog
# A leg's rate is the two-point slope of two chain times, noisy by a few percent: a write leg that reads
# 3,030-3,130 GB/s read 3,359.8 GB/s in one run of fourteen. A copy that was dropped reads a multiple of the rate.
HBM_RATE_MARGIN = 1.1
# published peaks of one H100 SXM at its full power limit (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = bench.H100_SXM_BF16_FLOPS  # dense, tensor cores, float32 accumulate
PEAK_F32_FLOPS = 67e12  # CUDA cores
PEAK_INT8_OPS = 1979e12  # dense int8, tensor cores, s32 accumulate
# the live engines: (a) the OnlineEngine's hops between zeroed counters, (b) the incremental engine's at 65,536
# streams, (c) the decision checks on 512 streams of 63,200 samples (56 whole windows, 63 hops)
ONLINE_STREAMS, ONLINE_STEPS, ONLINE_ZMUV = 512, 16, (-6.0, 4.0)
BIG_STREAMS, BIG_STEPS = 65536, 3
LIVE_SAMPLES = 63200
LIVE_MARGIN = 0.01  # how far from flipping the decision checks' decisions are picked
# the zoo's other families, each at its registered width (phase 11b)
FAMILY_NAMES = ("small-cnn", "seq-cnn", "mobilenet", "lstm", "seq-lstm", "gru", "las")
FAMILY_ITERS = 3  # timed batches a leg, after a warm-up
FAMILY_LIVE_HOPS = 24  # chained hops of each family's live engines (phase 11c): 1.5 s, 8 of them with whole windows
# the training entry point: envs/res8.env on a tone corpus of 24 positives and 24 negatives (12 train clips
# of each, 6 dev and 6 test of each) and 12 noise clips; 60 epochs of 10 steps separate it on the CPU by 40
ENTRY_CORPUS, ENTRY_EPOCHS, ENTRY_STEPS, ENTRY_RESUME_EPOCHS = 24, 60, 10, 2
FAMILY_TRAIN_EPOCHS = 26  # each family's training through the entry point (phase 17b), sized for the time (30 before 17f)
# the config-driven Trainer and the experiment harness (phase 17d): the Trainer's epochs of ENTRY_STEPS steps with
# time-stretching on, the harness's seeds and epochs of ENTRY_STEPS sweep steps (enough that its seeds fire on some
# clips, so the reports' curves move), and the tolerance of a seed's first-step loss against its own single-model
# step (tests/test_torch_seed_sweep.py's)
CONFIG_EPOCHS, HARNESS_SEEDS, HARNESS_EPOCHS, SWEEP_LOSS_RTOL = 6, 2, 40, 1e-6
# GSC pretraining and the dataset pipeline (phase 17e): (a) a Common Voice-layout tone corpus of STITCH_CLIPS clips
# mined, stub-aligned and stitched (STITCH_SAMPLES stitched train, dev and test clips), then trained through the entry
# point with --use-stitched-datasets for STITCH_EPOCHS epochs of ENTRY_STEPS steps; (b) a Speech Commands-layout tone
# corpus of the GSC-10 words, GSC_CLIPS 1 s clips a word (6 steps of 64 an epoch with 10 % silence, 12 labels), res8
# for GSC_EPOCHS epochs in float32, the two-seed bf16 sweep for as many, and the protocol harness, two seeds of
# GSC_PROTOCOL_EPOCHS epochs
GSC_WORDS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
STITCH_CLIPS, STITCH_SAMPLES, STITCH_EPOCHS = 72, (64, 16, 16), 4
GSC_CLIPS, GSC_EPOCHS, GSC_PROTOCOL_EPOCHS, GSC_BATCH = 64, 3, 2, 64
GSC_RECIPE = {"DATASET_PATH": "gsc", "VOCAB": json.dumps(GSC_WORDS), "BATCH_SIZE": str(GSC_BATCH),
              "MAX_WINDOW_SIZE_SECONDS": "1.0", "EVAL_WINDOW_SIZE_SECONDS": "1.0", "NUM_MELS": str(N_MELS),
              "LEARNING_RATE": "0.01", "LR_DECAY": "0.8", "WEIGHT_DECAY": "0.00001", "NUM_EPOCHS": str(GSC_EPOCHS),
              "USE_NOISE_DATASET": "False"}
# the serving surface (phase 17c): silence after each clip on the live engines (the trunk engine decides lag hops
# late), the multi-stream server's streams and ticks, the live tools' streams (the first live bottleneck's size),
# their DFT-grade samples, and the capacity calibration's stream counts (the bench's latency counts)
SERVE_PAD_S, SERVE_STREAMS, SERVE_TICKS, LIVE_TOOL_STREAMS, DFT_SAMPLES = 0.5, 512, 40, 65536, 3
SERVE_CALIBRATION, SERVE_CALIBRATION_STEPS = (1024, 16384, 65536), 4  # a check: the profiles take 52 steps a point


def _bound(n_bytes: float, ops: float, peak_flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once over the memory rate, or the operations
    over the peak rate of their type, whichever is larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "operations": int(ops), "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = _cuda_ms(plain, iters)
    k1 = _cuda_ms(kernel, iters)
    k2 = _cuda_ms(kernel, iters)
    p2 = _cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the magnitude of max |x| (8 significant bits)."""
    top = float(x.float().abs().max())
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def check_frontend(audio, cfg, zmuv) -> dict:
    """Both frontend kernels vs the plain log-mel frontend in every grade they
    serve; returns the record of the main path's case (grade "bf16", bf16
    output, "tm"), whose ``ms`` is the tensor-core ("tc") route's, the one the
    engine runs, and whose ``prev_ms`` is the float32-FMA ("fma") route's;
    the three-pass grade's ``ms_bf16x3`` and the exact grade's ``ms_f32``
    (six bf16 passes) are the "tc" route's too, beside the FMA kernel's
    ``prev_ms_bf16x3`` and ``prev_ms_f32``; ``bound_ms_f32`` is the six-pass
    bound, ``prev_bound_ms_f32`` the float32-peak bound of the FMA kernel.
    The "tc" kernel's "f32" must be nearer the plain "f32" than its "bf16x3"
    is."""
    import torch

    from howl_tpu_torch.ops.frontend_cuda import (
        ROUTES, frontend_route, log_mel_spectrogram_cuda, log_mel_spectrogram_plain,
    )

    mean, std = zmuv
    cases = [(g, d, "tm") for g in ("f32", "bf16x3", "bf16x2", "bf16") for d in (torch.float32, torch.bfloat16)]
    # "fm": the per-window scorer's layout ("bf16", bf16 out in the bf16 engine; "f32" in the float32 one)
    cases += [("bf16", torch.float32, "fm"), ("bf16", torch.bfloat16, "fm"), ("bf16x2", torch.bfloat16, "fm"),
              ("f32", torch.float32, "fm"), ("f32", torch.bfloat16, "fm"), ("bf16x3", torch.bfloat16, "fm")]
    errs = {}
    for grade, out_dtype, layout in cases:
        kw = dict(precision=grade, out_dtype=out_dtype, layout=layout)
        ref = log_mel_spectrogram_plain(audio, cfg, mean, std, **kw)
        # the tests' bounds: f32 and the three-pass grade 1e-3/std (the same
        # passes on both sides, the float32 sums in another order; "f32" on
        # "tc" is six bf16 passes, which drop terms of ~2^-24); bf16
        # operand grades 2e-2/std (the operands are bit-equal, the float32 sums
        # differ in order and the tensor cores do not round each partial sum as
        # fmaf does, which can flip one bf16 rounding of the power); bf16 output
        # adds one bf16 ulp of its magnitude for the same reason at the final
        # rounding
        tol = (1e-3 if grade in ("f32", "bf16x3") else 2e-2) / std
        if out_dtype == torch.bfloat16:
            tol += _bf16_ulp(ref)
        served = frontend_route(cfg, grade)
        for route in (r for r in ROUTES if r == "fma" or served == "tc"):
            got = log_mel_spectrogram_cuda(audio, cfg, mean, std, route=route, **kw)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"K1 {route} {grade}/{out_dtype}/{layout}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
            err = float((got.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(got.float()).all())
            print(f"K1 {route:3s} {grade:6s} out={str(out_dtype)[6:]:8s} {layout}: max_abs_err={err:.3e} tol={tol:.3e} finite={finite}")
            if not (finite and err <= tol):
                raise AssertionError(f"K1 {route} {grade}/{out_dtype}/{layout} disagrees with its plain version")
            errs[route, grade, out_dtype, layout] = err
            if (route, grade, out_dtype, layout) == (served, "bf16", torch.bfloat16, "tm"):
                mel = got
        del ref

    def timed(grade, route=None, plain=False, iters=5):
        fn = log_mel_spectrogram_plain if plain else log_mel_spectrogram_cuda
        kw = dict(precision=grade, out_dtype=torch.bfloat16, layout="tm", **({} if plain else {"route": route}))
        return _cuda_ms(lambda: fn(audio, cfg, mean, std, **kw), iters)

    if frontend_route(cfg, "bf16") != "tc":
        raise AssertionError(f"the main path's geometry {cfg} is not served by the tensor-core frontend kernel")
    # the main-path case in turns: plain, fma, tc, tc, fma, plain; then the two-pass grade: fma, tc, tc, fma
    turns = [timed("bf16", plain=True), timed("bf16", "fma"), timed("bf16", "tc"), timed("bf16", "tc"),
             timed("bf16", "fma"), timed("bf16", plain=True)]
    plain_ms, fma_ms, tc_ms = (turns[0] + turns[5]) / 2, (turns[1] + turns[4]) / 2, (turns[2] + turns[3]) / 2
    x2 = [timed("bf16x2", "fma"), timed("bf16x2", "tc"), timed("bf16x2", "tc"), timed("bf16x2", "fma")]
    tc_x2_ms, fma_x2_ms = (x2[1] + x2[2]) / 2, (x2[0] + x2[3]) / 2
    # the three-pass grade, the JAX kernel's default, on both kernels and its plain version: plain, fma, tc, tc,
    # fma, plain
    if frontend_route(cfg, "bf16x3") != "tc":
        raise AssertionError(f"the three-pass grade at {cfg} is not served by the tensor-core frontend kernel")
    x3 = [timed("bf16x3", plain=True, iters=2), timed("bf16x3", "fma", iters=2), timed("bf16x3", "tc"),
          timed("bf16x3", "tc"), timed("bf16x3", "fma", iters=2), timed("bf16x3", plain=True, iters=2)]
    plain_x3_ms, fma_x3_ms, tc_x3_ms = (x3[0] + x3[5]) / 2, (x3[1] + x3[4]) / 2, (x3[2] + x3[3]) / 2
    # the exact grade: six bf16 passes on "tc", float32 FMA on "fma", the float32 product plain: plain, fma, tc,
    # tc, fma, plain
    if frontend_route(cfg, "f32") != "tc":
        raise AssertionError(f"the exact grade at {cfg} is not served by the tensor-core frontend kernel")
    # six passes must be nearer the float32 product than three: a "tc" kernel that lost a group of products
    # would still meet 1e-3/std, but not this
    f32_ref = log_mel_spectrogram_plain(audio, cfg, mean, std, precision="f32", out_dtype=torch.float32, layout="tm")
    x3_out = log_mel_spectrogram_cuda(audio, cfg, mean, std, route="tc", precision="bf16x3", out_dtype=torch.float32,
                                      layout="tm")
    x3_vs_f32 = float((x3_out - f32_ref).abs().max())
    del f32_ref, x3_out
    x6_err = errs["tc", "f32", torch.float32, "tm"]
    print(f"K1 tc against the plain f32, float32 out, tm: f32 (six passes) {x6_err:.3e}, bf16x3 (three) {x3_vs_f32:.3e}")
    if not x6_err < x3_vs_f32:
        raise AssertionError(f"K1 tc f32 ({x6_err:.3e}) is no nearer the float32 product than bf16x3 ({x3_vs_f32:.3e})")
    f32 = [timed("f32", plain=True, iters=2), timed("f32", "fma", iters=3), timed("f32", "tc"), timed("f32", "tc"),
           timed("f32", "fma", iters=3), timed("f32", plain=True, iters=2)]
    plain_f32_ms, fma_f32_ms, tc_f32_ms = (f32[0] + f32[5]) / 2, (f32[1] + f32[4]) / 2, (f32[2] + f32[3]) / 2
    # bf16 operands, float32 sums: the DFT as (frames, n_fft) @ (n_fft, 2 bins), power, the mel product; the
    # same work whatever implements it
    frames, n_bins = mel.shape[0] * mel.shape[1], cfg.n_fft // 2
    dft, mel_mm, io = 2 * cfg.n_fft * 2 * n_bins, 2 * n_bins * cfg.n_mels, _nbytes(audio, mel)
    ops = frames * (dft + 3 * n_bins + mel_mm)
    w_fb_bytes = 4 * (cfg.n_fft * 2 * n_bins + n_bins * cfg.n_mels)
    # the exact grade: the same products in float32 on the CUDA cores; or, as the JAX kernel and the "tc" kernel
    # compute it, six products of bf16 parts with float32 sums (the float32 operands read once)
    f32_bound = _bound(io + w_fb_bytes, ops, PEAK_F32_FLOPS)
    x6_bound = _bound(io + w_fb_bytes, frames * (6 * (dft + mel_mm) + 3 * n_bins), PEAK_BF16_FLOPS)
    # the two-pass grade: two DFT products (W's hi and lo read), one mel product
    x2_bound = _bound(io + w_fb_bytes + 2 * cfg.n_fft * 2 * n_bins, frames * (2 * dft + 3 * n_bins + mel_mm),
                      PEAK_BF16_FLOPS)
    # the three-pass grade: three products of bf16 operands with float32 sums, both matrices' hi and lo read
    x3_bound = _bound(io + 2 * w_fb_bytes, frames * (3 * dft + 5 * n_bins + 3 * mel_mm), PEAK_BF16_FLOPS)
    record = {"max_abs_err": errs["tc", "bf16", torch.bfloat16, "tm"], "ms": tc_ms, "plain_ms": plain_ms, "mel": mel,
              "route_tc": True, "prev_ms": fma_ms, "prev_source": "howl_tpu_torch/csrc/frontend.cu",
              "prev_max_abs_err": errs["fma", "bf16", torch.bfloat16, "tm"], "ms_bf16x2": tc_x2_ms,
              "prev_ms_bf16x2": fma_x2_ms, "bound_ms_bf16x2": x2_bound["bound_ms"], "bound_by_bf16x2": x2_bound["bound_by"],
              "ms_bf16x3": tc_x3_ms, "prev_ms_bf16x3": fma_x3_ms, "plain_ms_bf16x3": plain_x3_ms,
              "max_abs_err_bf16x3": errs["tc", "bf16x3", torch.bfloat16, "tm"],
              "prev_max_abs_err_bf16x3": errs["fma", "bf16x3", torch.bfloat16, "tm"],
              "bound_ms_bf16x3": x3_bound["bound_ms"], "bound_by_bf16x3": x3_bound["bound_by"],
              "ms_f32": tc_f32_ms, "prev_ms_f32": fma_f32_ms, "plain_ms_f32": plain_f32_ms,
              "max_abs_err_f32": errs["tc", "f32", torch.bfloat16, "tm"],
              "prev_max_abs_err_f32": errs["fma", "f32", torch.bfloat16, "tm"],
              "max_abs_err_bf16x3_vs_f32": x3_vs_f32,
              "bound_ms_f32": x6_bound["bound_ms"], "bound_by_f32": x6_bound["bound_by"],
              "prev_bound_ms_f32": f32_bound["bound_ms"], "prev_bound_by_f32": f32_bound["bound_by"],
              **_bound(io + w_fb_bytes, ops, PEAK_BF16_FLOPS)}
    print(f"K1 main-path case: tc kernel {tc_ms:.3f} ms, fma kernel {fma_ms:.3f} ms, plain {plain_ms:.3f} ms per batch; "
          f"bound {record['bound_ms']:.4f} ms by {record['bound_by']}: {record['bound_ms'] / tc_ms:.3f} of the bound's rate")
    print(f"K1 grade bf16x2, bf16 out, tm: tc kernel {tc_x2_ms:.3f} ms, fma kernel {fma_x2_ms:.3f} ms; bound "
          f"{x2_bound['bound_ms']:.4f} ms by {x2_bound['bound_by']}: {x2_bound['bound_ms'] / tc_x2_ms:.3f} of its rate")
    print(f"K1 grade bf16x3, bf16 out, tm: tc kernel {tc_x3_ms:.3f} ms, fma kernel {fma_x3_ms:.3f} ms, plain "
          f"{plain_x3_ms:.3f} ms (turns {', '.join(f'{t:.3f}' for t in x3)}); bound {x3_bound['bound_ms']:.4f} ms by "
          f"{x3_bound['bound_by']}: tc {x3_bound['bound_ms'] / tc_x3_ms:.3f}, fma {x3_bound['bound_ms'] / fma_x3_ms:.3f} "
          f"of its rate")
    print(f"K1 grade f32, bf16 out, tm: tc kernel {tc_f32_ms:.3f} ms, fma kernel {fma_f32_ms:.3f} ms, plain "
          f"{plain_f32_ms:.3f} ms (turns {', '.join(f'{t:.3f}' for t in f32)}); six-pass bound "
          f"{x6_bound['bound_ms']:.4f} ms by {x6_bound['bound_by']}: tc {x6_bound['bound_ms'] / tc_f32_ms:.3f} of its "
          f"rate; float32-peak bound {f32_bound['bound_ms']:.4f} ms by {f32_bound['bound_by']}: tc "
          f"{f32_bound['bound_ms'] / tc_f32_ms:.3f}, fma {f32_bound['bound_ms'] / fma_f32_ms:.3f} of its rate")
    if not tc_ms < fma_ms:
        raise AssertionError(f"the tensor-core frontend kernel ({tc_ms:.3f} ms) is not faster than the FMA kernel ({fma_ms:.3f} ms)")
    if not tc_x3_ms < fma_x3_ms:
        raise AssertionError(f"at bf16x3 the tensor-core frontend kernel ({tc_x3_ms:.3f} ms) is not faster than the FMA "
                             f"kernel ({fma_x3_ms:.3f} ms)")
    if not tc_f32_ms < fma_f32_ms:
        raise AssertionError(f"at f32 the tensor-core frontend kernel ({tc_f32_ms:.3f} ms) is not faster than the FMA "
                             f"kernel ({fma_f32_ms:.3f} ms)")
    return record


def check_frontend_tiles(audio, cfg, zmuv, odd_audio) -> dict:
    """Every frame tile K1 is compiled for at 40 mels ("tc": 64, 128, 256; "fma": 16, 32, 64), in every grade the
    instance serves (``route_and_tile`` refuses a block that does not fit), with float32 and bf16 output in both
    layouts: bit for bit the route's default tile (128, 32) on ``audio`` and on ``odd_audio`` (clips whose rows are
    not 16-byte aligned, so every tile reads its span sample by sample), and within check_frontend's tolerance of
    the plain version. Times each instance and grade at bf16 output, "tm" (5 calls after a warm-up). Returns
    {(route, tile): {"grades", "ms_<grade>", "max_abs_err_<grade>", "bit_equal_default"}}."""
    import torch

    from howl_tpu_torch.ops.frontend_cuda import (
        FMA_TILE, FMA_TILES, GRADES, TC_TILE, TC_TILES, log_mel_spectrogram_cuda, log_mel_spectrogram_plain,
        route_and_tile,
    )

    mean, std = zmuv
    instances = [("tc", t) for t in TC_TILES[cfg.n_mels]] + [("fma", t) for t in FMA_TILES]
    default = {"tc": TC_TILE, "fma": FMA_TILE}
    out = {inst: {"grades": [], "bit_equal_default": True} for inst in instances}
    for grade in GRADES:
        served = []
        for route, tile in instances:
            try:
                route_and_tile(cfg, grade, tile, route)
                served.append((route, tile))
            except ValueError as e:
                print(f"K1 {route} tile {tile} {grade}: not served ({e})")
        for out_dtype in (torch.float32, torch.bfloat16):
            for layout in ("tm", "fm"):
                kw = dict(precision=grade, out_dtype=out_dtype, layout=layout)
                ref = log_mel_spectrogram_plain(audio, cfg, mean, std, **kw)
                tol = (1e-3 if grade in ("f32", "bf16x3") else 2e-2) / std
                if out_dtype == torch.bfloat16:
                    tol += _bf16_ulp(ref)
                base = {r: (log_mel_spectrogram_cuda(audio, cfg, mean, std, route=r, **kw),
                            log_mel_spectrogram_cuda(odd_audio, cfg, mean, std, route=r, **kw)) for r in default}
                for route, tile in served:
                    n = log_mel_spectrogram_cuda.launches_by_tile.get((route, tile), 0)
                    got = log_mel_spectrogram_cuda(audio, cfg, mean, std, route=route, frame_tile=tile, **kw)
                    got_odd = log_mel_spectrogram_cuda(odd_audio, cfg, mean, std, route=route, frame_tile=tile, **kw)
                    torch.cuda.synchronize()
                    if log_mel_spectrogram_cuda.launches_by_tile[route, tile] != n + 2:
                        raise AssertionError(f"K1 {route} tile {tile}: two calls did not launch that instance twice")
                    same = torch.equal(got, base[route][0]) and torch.equal(got_odd, base[route][1])
                    err = float((got.float() - ref.float()).abs().max())
                    ok = same and bool(torch.isfinite(got.float()).all()) and err <= tol
                    print(f"K1 {route:3s} tile {tile:3d} {grade:6s} out={str(out_dtype)[6:]:8s} {layout}: bit for bit "
                          f"the {default[route]}-frame tile {same}, max_abs_err={err:.3e} tol={tol:.3e}")
                    if not ok:
                        raise AssertionError(f"K1 {route} tile {tile} {grade}/{out_dtype}/{layout} disagrees")
                    rec = out[route, tile]
                    if grade not in rec["grades"]:
                        rec["grades"].append(grade)
                    if (out_dtype, layout) == (torch.bfloat16, "tm"):
                        rec[f"max_abs_err_{grade}"] = err
                del ref, base
        for route, tile in served:
            out[route, tile][f"ms_{grade}"] = _cuda_ms(lambda: log_mel_spectrogram_cuda(
                audio, cfg, mean, std, precision=grade, out_dtype=torch.bfloat16, layout="tm", route=route,
                frame_tile=tile), 5)
    for (route, tile), rec in out.items():
        print(f"K1 {route} tile {tile}: " + ", ".join(f"{g} {rec['ms_' + g]:.3f} ms" for g in rec["grades"])
              + " per batch (bf16 out, tm)")
    return out


def check_stem(mel_bf16, taps) -> dict:
    """Both stem kernels vs the plain res8 stem: "tc" in bf16, "fma" in bf16
    and float32; returns the record of the main path's case (bf16), whose
    ``ms`` is the tensor-core route's, the one the bf16 engine runs, and whose
    ``prev_ms`` is the float32-FMA route's."""
    import torch

    from howl_tpu_torch.ops.frontend import round_bf16
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain, stem_route

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        mel = mel_bf16.to(dtype).contiguous()
        w = round_bf16(taps) if dtype == torch.bfloat16 else taps
        ref = res8_stem_plain(mel, w)
        tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5
        for route in ("tc", "fma") if dtype == torch.bfloat16 else ("fma",):
            got = res8_stem_cuda(mel, w, route=route)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"K2 {route} {dtype}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
            err = float((got.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(got.float()).all())
            print(f"K2 {route:3s} {str(dtype)[6:]:8s} {tuple(mel.shape)} -> {tuple(got.shape)}: max_abs_err={err:.3e} "
                  f"tol={tol:.3e} finite={finite}")
            if not (finite and err <= tol):
                raise AssertionError(f"K2 {route} {dtype} disagrees with its plain version")
            errs[route, dtype] = err
            del got
        del ref
    mel, w = mel_bf16.contiguous(), round_bf16(taps)
    if stem_route(mel.dtype, mel.shape[-1], w.shape[-1]) != "tc":
        raise AssertionError("the main path's stem geometry is not served by the tensor-core stem kernel")

    def timed(route=None, iters=10):
        if route is None:
            return _cuda_ms(lambda: res8_stem_plain(mel, w), iters)
        return _cuda_ms(lambda: res8_stem_cuda(mel, w, route=route), iters)

    # plain, fma, tc, tc, fma, plain
    turns = [timed(), timed("fma"), timed("tc"), timed("tc"), timed("fma"), timed()]
    plain_ms, fma_ms, tc_ms = (turns[0] + turns[5]) / 2, (turns[1] + turns[4]) / 2, (turns[2] + turns[3]) / 2
    out = res8_stem_cuda(mel, w)
    ops = mel.numel() * taps.shape[2] * 9 * 2 + out.numel() * 12  # conv0 at full resolution, the pool's sums
    record = {"max_abs_err": errs["tc", torch.bfloat16], "ms": tc_ms, "plain_ms": plain_ms, "route_tc": True,
              "prev_ms": fma_ms, "prev_source": "howl_tpu_torch/csrc/stem.cu",
              "prev_max_abs_err": errs["fma", torch.bfloat16], "max_abs_err_f32_fma": errs["fma", torch.float32],
              **_bound(_nbytes(mel, w, out), ops, PEAK_BF16_FLOPS)}
    print(f"K2 main-path case: tc kernel {tc_ms:.4f} ms, fma kernel {fma_ms:.4f} ms, plain {plain_ms:.3f} ms per batch; "
          f"bound {record['bound_ms']:.4f} ms by {record['bound_by']}: {record['bound_ms'] / tc_ms:.3f} of the bound's rate")
    if not tc_ms < fma_ms:
        raise AssertionError(f"the tensor-core stem kernel ({tc_ms:.4f} ms) is not faster than the FMA kernel ({fma_ms:.4f} ms)")
    return record


def check_noise_mix(dev) -> dict:
    """Kernel vs plain noise-bank mix, bit for bit, at the train step's shape,
    on a narrow bank and at a ragged window; returns the train step's record."""
    import torch

    from howl_tpu_torch.ops import augment as aug
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda, mix_noise_bank_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    record = None
    cases = (("train-step", BANK_SHAPE, TRAIN_WINDOW), ("narrow-bank", (BANK_SHAPE[0], 5000), TRAIN_WINDOW),
             ("ragged-window", BANK_SHAPE, 7919))
    for name, bank_shape, n in cases:
        bank = aug.prepare_noise_bank(torch.randn(bank_shape, generator=gen, device=dev) * 0.05, n)
        audio = torch.randn((TRAIN_BATCH, n), generator=gen, device=dev) * 0.1
        d = aug.draw_mix_noise_bank(gen, TRAIN_BATCH, bank, aug.AugmentConfig(), REPLACE_PROB)
        args = (audio, bank.extended, d.rows, d.offs, d.alpha)
        got = mix_noise_bank_cuda(*args)
        ref = mix_noise_bank_plain(*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        err = float((got - ref).abs().max())
        kernel_ms, plain_ms = _ab_ms(lambda: mix_noise_bank_plain(*args), lambda: mix_noise_bank_cuda(*args), iters=20)
        print(
            f"K3 {name:13s} audio {tuple(audio.shape)} bank {bank_shape}: bitwise={bitwise} max_abs_err={err:.3e} "
            f"(alpha 0 rows {int((d.alpha == 0).sum())}, replaced {int(d.replaced.sum())}); "
            f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
        if not bitwise:
            raise AssertionError(f"K3 {name}: the kernel is not bitwise equal to its plain version")
        if record is None:
            # rows with alpha 0 copy the audio and read no noise window: count the windows this run's draws need
            mixed_rows = int((d.alpha != 0).sum())
            n_bytes = _nbytes(audio, got, d.rows, d.offs, d.alpha) + mixed_rows * n * 4
            record = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                      **_bound(n_bytes, 4 * audio.numel(), PEAK_F32_FLOPS)}
            print(f"K3 train-step case: bound {record['bound_ms']:.4f} ms by {record['bound_by']} ({n_bytes} bytes)")
        del bank, audio, got, ref
    return record


def drive_trunk_study(dev) -> dict:
    """The trunk-kernel study's path: ``bench_trunk_kernel_micro.run`` at
    512 x 8 s in bf16, with T1's and T2's launch counts zeroed just before
    and read just after; then each kernel held against its plain version on
    the study's own inputs. Returns the kernels' records."""
    import torch

    from howl_tpu_torch.tools import bench_trunk_kernel_micro as study
    from howl_tpu_torch.tools.trunk_kernels import (
        stem_fold_cuda, stem_fold_plain, stem_prep, trunk_proto_cuda, trunk_proto_plain,
    )

    trunk_proto_cuda.launches = 0
    stem_fold_cuda.launches = 0
    legs, inp = study.run(BATCH, CLIP_SECONDS, STUDY_ITERS, SEED, dev)
    torch.cuda.synchronize()
    launches = {"t1": trunk_proto_cuda.launches, "t2": stem_fold_cuda.launches}
    print(f"study path launches: trunk proto kernel {launches['t1']}, stem fold kernel {launches['t2']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the study's path was not launched: {launches}")

    # the bounds of tests/test_torch_trunk_micro.py: T1 2e-3 of the output's
    # largest magnitude (bf16 x and res after every layer, sums in other
    # orders); T2 1e-5 of it in float32, one bf16 ulp of it in bf16
    g = inp.geom
    t1_err = 0.0
    for variant, ws, full_build in (("full-build", inp.ws_full, True), ("gemm-only", inp.ws_gemm, False)):
        ops = (inp.x_pm, ws, inp.pool_t, inp.bn_scale, inp.bn_shift, g.pos, full_build)
        got, ref = trunk_proto_cuda(*ops), trunk_proto_plain(*ops)
        torch.cuda.synchronize()
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        finite = bool(torch.isfinite(got).all())
        print(f"T1 {variant:10s} {tuple(inp.x_pm.shape)} -> {tuple(got.shape)}: max_abs_err={err:.3e} "
              f"tol={2e-3 * top:.3e} finite={finite}")
        if got.shape != ref.shape or not (finite and err <= 2e-3 * top):
            raise AssertionError(f"T1 {variant} disagrees with its plain version")
        t1_err = max(t1_err, err)
        del got, ref
    xpre = stem_prep(inp.mel).contiguous()
    t2 = None
    for dtype in (torch.bfloat16, torch.float32):
        got, ref = stem_fold_cuda(xpre, inp.w0fold, dtype), stem_fold_plain(xpre, inp.w0fold, dtype)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5 * float(ref.abs().max())
        finite = bool(torch.isfinite(got.float()).all())
        print(f"T2 {str(dtype)[6:]:8s} {tuple(xpre.shape)} -> {tuple(got.shape)}: max_abs_err={err:.3e} "
              f"tol={tol:.3e} finite={finite}")
        if got.shape != ref.shape or got.dtype != dtype or not (finite and err <= tol):
            raise AssertionError(f"T2 {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            kernel_ms, plain_ms = _ab_ms(lambda: stem_fold_plain(xpre, inp.w0fold, dtype),
                                         lambda: stem_fold_cuda(xpre, inp.w0fold, dtype), iters=10)
            ops = xpre.numel() * inp.w0fold.shape[1] * 2  # three planes of (q_rows, 120) @ (120, 2048)
            t2 = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                  **_bound(_nbytes(xpre, inp.w0fold, got), ops, PEAK_BF16_FLOPS)}
            print(f"T2 alone, bf16: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms per batch; "
                  f"bound {t2['bound_ms']:.4f} ms by {t2['bound_by']}")
        del got, ref
    leg3 = legs["cuda fused 6-layer proto + pool gemm"]
    # six layers of (pos_pad, 432) @ (432, 48) and the pool product (n_win_pad, pos_pad) @ (pos_pad, 48), per clip
    b, pos_pad, ch = inp.x_pm.shape
    ops = b * 2 * ch * pos_pad * (6 * inp.ws_full.shape[1] + inp.pool_t.shape[0])
    n_bytes = _nbytes(inp.x_pm, inp.ws_full, inp.pool_t, inp.bn_scale, inp.bn_shift) + b * inp.pool_t.shape[0] * ch * 4
    t1 = {"max_abs_err": t1_err, "ms": float(np.mean(leg3["ms"])), "plain_ms": float(np.mean(leg3["plain_ms"])),
          "ms_gemm_only": float(np.mean(legs["cuda gemm-only (im2col built once)"]["ms"])),
          **_bound(n_bytes, ops, PEAK_BF16_FLOPS)}
    print(f"T1 bound {t1['bound_ms']:.4f} ms by {t1['bound_by']}")
    return {"launches": launches, "t1": t1, "t2": t2}


def print_sass_counts(library) -> None:
    """Count the tensor-core (HGMMA for ``wgmma``, HMMA for ``mma.sync``),
    cp.async (LDGSTS) and bulk-copy (UBLKCP) opcodes that the compiler left
    in each kernel of the frontend, the stem, the two trunk study kernels,
    the frontend study and the bandwidth sweep, from ``cuobjdump -sass`` of
    the built library. The studies' kernels move and compute what nobody
    reads, and this shows that the work and the asynchronous copy paths are
    still there. The run fails unless the tensor-core frontend kernel, the
    stem fold kernel, the trunk proto and the frontend study's GEMM and
    polyphase kernels hold HGMMA and UBLKCP, the polyphase kernel no HMMA,
    and the tensor-core stem kernel holds HMMA or HGMMA."""
    import re
    import shutil
    from pathlib import Path

    from howl_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found beside nvcc: the tensor-core kernels' opcodes cannot be checked")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True, timeout=300).stdout
    opcodes = ("HGMMA", "HMMA", "LDGSTS", "UBLKCP")
    # the kernels that must be in the library, and the opcodes each must hold ("A|B": either)
    required = {"logmel_tc_kernel": ("HGMMA", "UBLKCP"), "stem_fold_kernel": ("HGMMA", "UBLKCP"),
                "trunk_proto_kernel": ("HGMMA", "UBLKCP"), "micro_gemm_kernel": ("HGMMA", "UBLKCP"),
                "micro_poly_kernel": ("HGMMA", "UBLKCP"), "stem_tc_kernel": ("HMMA|HGMMA",)}
    forbidden = {"micro_poly_kernel": "HMMA"}  # every product on wgmma
    found = dict.fromkeys(required, 0)
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, flags=re.S):
        kernel = re.findall(r"(?:micro_[a-z]+|hbm_[a-z_]+?|hbm2hbm|logmel(?:_tc)?|stem(?:_tc|_fold)?|trunk_proto)_kernel",
                            name)
        if kernel:
            args = re.findall(r"IL([bi])(\d+)E(?:L([bi])(\d+)E)?", name)
            names = {("b", "0"): "float32", ("b", "1"): "bf16", ("i", "40"): "mel width 40", ("i", "80"): "mel width 80"}
            if kernel[-1] == "logmel_tc_kernel" and args:  # <mel width, the bf16 parts of the split operands, tile>
                names.update({("i", "1"): "one or two passes", ("i", "2"): "three passes", ("i", "3"): "six passes"})
            parts = [names.get(pair, "".join(pair)) for a in args[:1] for pair in zip(a[::2], a[1::2]) if pair[0]]
            if kernel[-1] in ("logmel_tc_kernel", "logmel_kernel"):  # their last argument is the frame tile
                tile = re.search(r"L[bi]\d+ELi(\d+)EEE", name)
                if kernel[-1] == "logmel_kernel":  # <three passes, tile>; else W is one float32 matrix
                    parts = ["three passes" if parts[:1] == ["bf16"] else "one pass"]
                parts = parts[:2] + ([f"{tile.group(1)}-frame tile"] if tile else [])
            variant = f" ({', '.join(parts)})" if parts else ""
            counts = {op: len(re.findall(rf"\b{op}\b", body)) for op in opcodes}
            print(f"SASS of {kernel[-1]}{variant}: " + ", ".join(f"{n} {op}" for op, n in counts.items()))
            if kernel[-1] in required:
                found[kernel[-1]] += 1
                for need in required[kernel[-1]]:
                    if not any(counts[op] for op in need.split("|")):
                        raise AssertionError(f"{kernel[-1]}{variant} holds {counts}: no {need}")
                if counts.get(forbidden.get(kernel[-1]), 0):
                    raise AssertionError(f"{kernel[-1]}{variant} holds {counts}: {forbidden[kernel[-1]]} as well")
    if min(found.values()) < 1:
        raise AssertionError(f"the built library lacks a tensor-core kernel: {found}")


def drive_frontend_study(dev) -> dict:
    """The frontend cost study's path: ``bench_pallas_micro.run`` at 512 x
    8 s, with M1's, M2's and M3's launch counts zeroed just before and read
    just after; then each kernel held against its plain version on the
    study's own inputs with a nonzero scalar; then the frontend kernel's
    grades against the float64 goldens. Returns the kernels' records."""
    import torch

    from howl_tpu_torch.tools import bench_pallas_micro as study
    from howl_tpu_torch.tools import validate_pallas_precision
    from howl_tpu_torch.tools.frontend_micro_kernels import (
        OUT_COLS as out_cols, gemm_cuda, gemm_plain, poly_cuda, poly_plain, stream_cuda, stream_plain,
    )

    wrappers = {"m1": stream_cuda, "m2": gemm_cuda, "m3": poly_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    legs, inp = study.run(BATCH, CLIP_SECONDS, STUDY_ITERS, SEED, dev)
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in wrappers.items()}
    print(f"frontend study path launches: stream kernel {launches['m1']}, gemm kernel {launches['m2']}, "
          f"polyphase kernel {launches['m3']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the frontend study's path was not launched: {launches}")
    ms = {name: float(np.mean(rec["ms"])) for name, rec in legs.items()}
    plain = {name: float(np.mean(rec["plain_ms"])) for name, rec in legs.items() if rec["plain_ms"]}
    stream, gemm1, gemm3, poly1, poly3, _, lib_stream = list(legs)[:7]
    print(f"what a product adds: gemm1 - stream {ms[gemm1] - ms[stream]:.3f} ms, (gemm3 - gemm1) / 2 "
          f"{(ms[gemm3] - ms[gemm1]) / 2:.3f} ms, (x3 - x1) / 2 {(ms[poly3] - ms[poly1]) / 2:.3f} ms; "
          f"x1 - gemm1 {ms[poly1] - ms[gemm1]:.3f} ms")
    # two of the three products are thrown away; a compiler that dropped them would make the legs equal
    if not (ms[gemm3] > 1.5 * ms[gemm1] and ms[poly3] > 1.5 * ms[poly1]):
        raise AssertionError("three products take under 1.5 x one product's time: the discarded passes did not run")

    x, w, h, g = inp.frames, inp.w, inp.h, inp.geom
    got, ref = stream_cuda(x, MICRO_S), stream_plain(x, MICRO_S)
    torch.cuda.synchronize()
    bitwise = got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got.view(torch.int32), ref.view(torch.int32))
    m1_err = float((got - ref).abs().max())
    print(f"M1 {tuple(x.shape)} -> {tuple(got.shape)}: bitwise={bitwise} max_abs_err={m1_err:.3e} "
          f"finite={bool(torch.isfinite(got).all())}")
    if not bitwise:
        raise AssertionError("M1: the stream kernel is not bitwise equal to its plain version")
    out_bytes = _nbytes(got)
    del got, ref

    # the bound of tests/test_torch_pallas_micro.py: 1e-5 of the output's
    # largest magnitude, for the order of the float32 sums over K = 512
    errs = {"m2": 0.0, "m3": 0.0}
    for key, name, kernel, ref_fn, args in (
        ("m2", "M2", gemm_cuda, gemm_plain, (x, w, MICRO_S)), ("m3", "M3", poly_cuda, poly_plain, (h, w, MICRO_S, g.t_pad)),
    ):
        for n_dots in (1, 3):
            got, ref = kernel(*args, n_dots), ref_fn(*args, n_dots)
            torch.cuda.synchronize()
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"{name} n_dots={n_dots} {tuple(args[0].shape)} -> {tuple(got.shape)} {str(got.dtype)[6:]}: "
                  f"max_abs_err={err:.3e} tol={1e-5 * top:.3e} finite={finite}")
            if got.shape != ref.shape or got.dtype != torch.float32 or not (finite and err <= 1e-5 * top):
                raise AssertionError(f"{name} with n_dots={n_dots} disagrees with its plain version")
            errs[key] = max(errs[key], err)
            del got, ref

    # The bound is the function's own: M1 reads the 128 columns it returns; M2 reads every frame row and W's 128
    # stored columns and adds n_dots products of that width; M3 reads the hop rows a clip's t_pad frames span,
    # and only its last pass reaches the output. The staged bound counts what the study defines as a leg's
    # work instead: every byte of a block staged, the whole 512-wide product, every pass.
    rows_m3 = g.batch * g.t_pad
    h_bytes = g.batch * (g.t_pad + g.n_sub - 1) * g.hop * 4
    dot_ops, w_cols = 2 * g.n_fft * out_cols, _nbytes(w) * out_cols // g.n_fft
    full_ops = 2 * g.n_fft * g.n_fft
    bounds = {
        "m1": _bound(2 * out_bytes, x.shape[0] * out_cols, PEAK_F32_FLOPS),
        "m2": _bound(_nbytes(x) + w_cols + out_bytes, x.shape[0] * dot_ops, PEAK_BF16_FLOPS),
        "m2x3": _bound(_nbytes(x) + w_cols + out_bytes, 3 * x.shape[0] * dot_ops, PEAK_BF16_FLOPS),
        "m3": _bound(h_bytes + w_cols + rows_m3 * out_cols * 4, rows_m3 * dot_ops, PEAK_BF16_FLOPS),
    }
    bounds["m3x3"] = bounds["m3"]
    staged = {
        "m1": _bound(_nbytes(x) + out_bytes, x.shape[0] * out_cols, PEAK_F32_FLOPS),
        "m2": _bound(_nbytes(x, w) + out_bytes, x.shape[0] * full_ops, PEAK_BF16_FLOPS),
        "m2x3": _bound(_nbytes(x, w) + out_bytes, 3 * x.shape[0] * full_ops, PEAK_BF16_FLOPS),
        "m3": _bound(h_bytes + _nbytes(w) + rows_m3 * out_cols * 4, rows_m3 * full_ops, PEAK_BF16_FLOPS),
        "m3x3": _bound(h_bytes + _nbytes(w) + rows_m3 * out_cols * 4, 3 * rows_m3 * full_ops, PEAK_BF16_FLOPS),
    }
    for key, name in (("m1", stream), ("m2", gemm1), ("m2x3", gemm3), ("m3", poly1), ("m3x3", poly3)):
        bd, st = bounds[key], staged[key]
        print(f"{name}: {ms[name]:.3f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['bytes']} bytes, {bd['operations']} operations): {bd['bound_ms'] / ms[name]:.3f} of the bound's rate; "
              f"staged bound {st['bound_ms']:.4f} ms by {st['bound_by']} ({st['bytes']} bytes, {st['operations']} "
              f"operations): {st['bound_ms'] / ms[name]:.3f}")
    print(f"M1 beside the one PyTorch call of its function, x[:, :{out_cols}] + s: {ms[stream]:.3f} ms against {ms[lib_stream]:.3f} ms")
    del inp, x, h

    print("frontend kernel grades against the float64 goldens (no ZMUV):")
    records = validate_pallas_precision.run(dev)
    for rec in records:
        # tests/test_golden_frontend.py's bounds: the float32 grade's, and the three-pass grade's tiers
        if not validate_pallas_precision.within_golden_bounds(rec):
            raise AssertionError(f"K1's {rec['grade']} grade misses the golden bounds: {rec}")
    if not any(r["grade"] == "bf16x3" and r["route"] == "tc" for r in records):
        raise AssertionError("the golden check did not run the three-pass grade on the tensor-core kernel")

    def record(key, name, name3=None):
        out = {"max_abs_err": errs.get(key, m1_err), "ms": ms[name], "plain_ms": plain[name], **bounds[key],
               "staged_bound_ms": staged[key]["bound_ms"], "staged_bound_by": staged[key]["bound_by"]}
        if name3:
            out.update(ms_n_dots3=ms[name3], plain_ms_n_dots3=plain[name3], bound_ms_n_dots3=bounds[key + "x3"]["bound_ms"],
                       bound_by_n_dots3=bounds[key + "x3"]["bound_by"],
                       staged_bound_ms_n_dots3=staged[key + "x3"]["bound_ms"])
        return out

    # M1's function is one PyTorch call, timed as the study's first library leg; M2 and M3 are chains of calls
    return {"launches": launches, "m1": {**record("m1", stream), "library_ms": ms[lib_stream]},
            "m2": record("m2", gemm1, gemm3), "m3": record("m3", poly1, poly3)}


def drive_hbm_sweep(dev) -> dict:
    """The bandwidth sweep's path: ``bench_hbm_sweep.run`` at 256 MB, the
    full list, with the seven kernels' launch counts zeroed just before and
    read just after; then each kernel held against its plain version, bit
    for bit over the whole output. Returns the kernels' records."""
    import faulthandler

    import torch

    from howl_tpu_torch.tools import bench_hbm_sweep as study
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    # a wrong mbarrier parity hangs rather than miscomputes: the kernel traps after 2 s of waiting, and
    # should the phase sit all the same, this ends the process with a traceback and exit code 1
    faulthandler.dump_traceback_later(HBM_PHASE_LIMIT_S, exit=True)
    for fn in study.KERNELS.values():
        fn.launches = 0
    records, made = study.run(HBM_MB, HBM_ITERS, False, SEED, dev)
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in study.KERNELS.items()}
    print(f"bandwidth sweep path launches: {launches}; the sweep's own tally {made}")
    if launches != made or min(launches.values()) < 1:
        raise AssertionError(f"the kernels' launch counts {launches} are not the launches the sweep made {made}")
    legs = {rec["config"]: rec for rec in records}
    for name, rec in legs.items():
        if rec["route"] == "cuda kernel" and rec["gbps"] * 1e9 > HBM_RATE_MARGIN * PEAK_BYTES_PER_S:
            raise AssertionError(f"{name} reads {rec['gbps']:.1f} GB/s, over {HBM_RATE_MARGIN} x the card's memory rate: "
                                 "a copy was dropped or the bytes are miscounted")

    def bits(t):
        return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def hold(name, got, ref):
        torch.cuda.synchronize()
        same = got.shape == ref.shape and got.dtype == ref.dtype and torch.equal(bits(got), bits(ref))
        err = float((got.float() - ref.float()).abs().max()) if got.shape == ref.shape else float("nan")
        print(f"{name} -> {tuple(got.shape)} {str(got.dtype)[6:]}: bitwise={same} max_abs_err={err:.3e}")
        if not same:
            raise AssertionError(f"{name}: the kernel is not bitwise equal to its plain version")
        return err

    _, x32, x16 = study.make_inputs(HBM_MB, SEED, dev)
    odd = x32[:HBM_ODD_ROWS]
    cases = [(x32, "f32 256 MB", 256), (x32, "f32 256 MB", 4096), (x16, "bf16 256 MB", 1024),
             (odd, f"f32 {HBM_ODD_ROWS} rows", HBM_ODD_BN), (odd.to(torch.bfloat16), f"bf16 {HBM_ODD_ROWS} rows", HBM_ODD_BN)]
    errs = dict.fromkeys(study.KERNELS, 0.0)
    for x, tag, bn in cases:
        for key, got, ref in (
            ("auto_read", hk.auto_read_cuda(x, bn, HBM_S), hk.auto_read_plain(x, bn, HBM_S)),
            ("auto_copy", hk.auto_copy_cuda(x, bn, HBM_S), hk.auto_copy_plain(x, HBM_S)),
            ("stream_repro", hk.stream_repro_cuda(x, bn, HBM_S), hk.stream_repro_plain(x, HBM_S)),
        ):
            errs[key] = max(errs[key], hold(f"{key} {tag} bn={bn}", got, ref))
            del got, ref
    for x, tag in ((x32, "f32 256 MB"), (x16, "bf16 256 MB"), (odd, f"f32 {HBM_ODD_ROWS} rows")):
        (out, done), (ref, ref_done) = hk.hbm2hbm_cuda(x, HBM_S), hk.hbm2hbm_plain(x, HBM_S)
        errs["hbm2hbm"] = max(errs["hbm2hbm"], hold(f"hbm2hbm {tag}", out, x), hold(f"hbm2hbm {tag} done", done, ref_done))
        if not torch.equal(bits(ref), bits(x)):
            raise AssertionError("hbm2hbm's plain version is no copy")
        del out, done, ref
    odd16 = odd.to(torch.bfloat16)
    ring_cases = ([(x32, "f32 256 MB", kc) for kc in HBM_RING_F32] + [(x16, "bf16 256 MB", kc) for kc in HBM_RING_BF16]
                  + [(x, f"{tag} {HBM_ODD_ROWS} rows", kc) for kc in HBM_RING_ODD for x, tag in ((odd, "f32"), (odd16, "bf16"))])
    for x, tag, (k, cb) in ring_cases:
        name = f"{tag} k={k} cb={cb}"
        errs["manual_read"] = max(errs["manual_read"], hold(f"manual_read {name}", hk.manual_read_cuda(x, k, cb, HBM_S),
                                                            hk.manual_read_plain(x, k, cb, HBM_S)))
        (out, done), (ref, ref_done) = hk.manual_write_cuda(x, k, cb, HBM_S), hk.manual_write_plain(x, k, cb, HBM_S)
        errs["manual_write"] = max(errs["manual_write"], hold(f"manual_write {name}", out, ref),
                                   hold(f"manual_write {name} done", done, ref_done))
        del out, ref
        out, done = hk.manual_copy_cuda(x, k, cb, HBM_S)
        errs["manual_copy"] = max(errs["manual_copy"], hold(f"manual_copy {name}", out, x),
                                  hold(f"manual_copy {name} done", done, ref_done))
        del out
    # the three copies launched HBM_REPEATS times in a row on as many arrays, all in flight before the first is held:
    # a wrong mbarrier phase, a slot refilled too early or a stage left out shows only now and then
    k0, cb0 = study.MANUAL_KS[0], study.MANUAL_CBS[0]
    arrays = [x32.roll(7 * i + 1, 0) for i in range(HBM_REPEATS)]
    outs = [hk.auto_copy_cuda(x, study.BNS[0], HBM_S) for x in arrays]
    for i, (x, out) in enumerate(zip(arrays, outs)):
        errs["auto_copy"] = max(errs["auto_copy"], hold(f"auto_copy f32 256 MB bn={study.BNS[0]}, launch {i + 1} of "
                                                        f"{HBM_REPEATS} in a row", out, hk.auto_copy_plain(x, HBM_S)))
    del outs
    for key, copy in (("manual_copy", lambda x: hk.manual_copy_cuda(x, k0, cb0, HBM_S)),
                      ("hbm2hbm", lambda x: hk.hbm2hbm_cuda(x, HBM_S))):
        outs = [copy(x) for x in arrays]
        for i, (x, (out, done)) in enumerate(zip(arrays, outs)):
            errs[key] = max(errs[key], hold(f"{key} f32 256 MB, launch {i + 1} of {HBM_REPEATS} in a row", out, x),
                            hold(f"{key} launch {i + 1} done", done, hk.hbm2hbm_plain(x[:0], HBM_S)[1]))
        del outs
    del arrays
    faulthandler.cancel_dump_traceback_later()

    # The bound is the function's own: a read block needs its corner alone, the stream leg the quarter of
    # the array it returns. The staged bound counts what the sweep defines: the whole array read, the output
    # written. Both at the sweep's first block height, 256, in float32, which is also the leg whose times the
    # kernels line carries; the other block heights' times are in ``ms_by_leg``.
    # The manual legs at the sweep's first one, k = 2 and cb = 512 in float32. The write's and the copy's function
    # is the ring's traffic: the array written, or read and written. The manual read's function needs its chunks'
    # corners alone (read once, one add per element, (8, 128) written), as the auto read's does; what its ring
    # moves (the whole array read, each corner written to the scratch and read again by the summing kernel) is its
    # staged bound.
    n_x, bn = _nbytes(x32), study.BNS[0]
    corners = x32.shape[0] // bn * hk.CORNER_ROWS * hk.OUT_COLS
    quarter = x32.shape[0] * hk.OUT_COLS
    chunk_corners, done_bytes = x32.shape[0] // cb0 * hk.CORNER_ROWS * hk.OUT_COLS, 4 * hk.CORNER_ROWS * hk.OUT_COLS
    bounds = {
        "manual_read": _bound(chunk_corners * 4 + done_bytes, chunk_corners, PEAK_F32_FLOPS),
        "manual_write": _bound(n_x + done_bytes, x32.shape[0] // cb0, PEAK_F32_FLOPS),
        "manual_copy": _bound(2 * n_x + done_bytes, 0, PEAK_F32_FLOPS),
        "auto_read": _bound(2 * corners * 4, corners, PEAK_F32_FLOPS),
        "auto_copy": _bound(2 * n_x, x32.numel(), PEAK_F32_FLOPS),
        "stream_repro": _bound(2 * quarter * 4, quarter, PEAK_F32_FLOPS),
        "hbm2hbm": _bound(2 * n_x + 4 * 8 * 128, 0, PEAK_F32_FLOPS),
    }
    staged = {
        "auto_read": _bound(n_x + corners * 4, corners, PEAK_F32_FLOPS),
        "auto_copy": bounds["auto_copy"],
        "stream_repro": _bound(n_x + quarter * 4, quarter, PEAK_F32_FLOPS),
        "hbm2hbm": bounds["hbm2hbm"],
        "manual_read": _bound(n_x + 2 * chunk_corners * 4 + done_bytes, chunk_corners, PEAK_F32_FLOPS),
        "manual_write": bounds["manual_write"],
        "manual_copy": bounds["manual_copy"],
    }
    lib_add, lib_slice, lib_copy, lib_corners, lib_ring_read, lib_ring_write = (
        rec["ms_per_iter"] for rec in records if rec["library"])
    main_leg = {"auto_read": f"auto read  f32 bn={bn}", "auto_copy": f"auto copy  f32 bn={bn}",
                "stream_repro": f"stream-264-repro f32 bn={study.STREAM_BN} (r+w/4)", "hbm2hbm": "hbm->hbm whole-array DMA (r+w)",
                **{f"manual_{mode}": f"manual {mode:5s} f32 k={k0} cb={cb0}" for mode in study.MANUAL}}
    # each function is one PyTorch call; the read leg's is an add over a strided view of the corners, and must
    # equal the plain version, which gathers before it adds
    if not torch.equal(bits(study.auto_read_library(x32, bn, HBM_S)), bits(hk.auto_read_plain(x32, bn, HBM_S))):
        raise AssertionError("the read leg's library call is not bitwise equal to its plain version")
    # the manual read's library call sums the corners as a tree: within 1e-3 of the sequential sum of 256 unit
    # normals, not bit for bit; the manual write's is a broadcast copy and must be exact
    lib_sum, seq_sum = study.manual_read_library(x32, cb0, HBM_S), hk.manual_read_plain(x32, k0, cb0, HBM_S)
    lib_err = float((lib_sum - seq_sum).abs().max())
    print(f"manual read's library call against the sequential sum: max_abs_err={lib_err:.3e} tol=1.000e-03")
    if not lib_err <= 1e-3:
        raise AssertionError("the manual read's library call disagrees with its plain version")
    filled = study.manual_write_library(torch.empty_like(x32), hk.chunk_values(x32, cb0, HBM_S), cb0)
    if not torch.equal(bits(filled), bits(hk.manual_write_plain(x32, k0, cb0, HBM_S)[0])):
        raise AssertionError("the manual write's library call is not bitwise equal to its plain version")
    del filled
    library = {"auto_read": lib_corners, "auto_copy": lib_add, "stream_repro": lib_slice, "hbm2hbm": lib_copy,
               "manual_read": lib_ring_read, "manual_write": lib_ring_write, "manual_copy": lib_copy}
    prefix = {"auto_read": "auto read", "auto_copy": "auto copy", "stream_repro": "stream", "hbm2hbm": "hbm->hbm",
              "manual_read": "manual read", "manual_write": "manual write", "manual_copy": "manual copy"}
    out = {"launches": launches}
    for key in study.KERNELS:
        rec, bd, st = legs[main_leg[key]], bounds[key], staged[key]
        print(f"{main_leg[key]}: {rec['ms_per_iter']:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['bytes']} bytes, {bd['operations']} operations); staged bound {st['bound_ms']:.4f} ms "
              f"({st['bytes']} bytes): {st['bound_ms'] / rec['ms_per_iter']:.3f} of the memory rate; library "
              f"{library[key]:.4f} ms")
        out[key] = {"max_abs_err": errs[key], "ms": rec["ms_per_iter"], "plain_ms": rec["plain_ms_per_iter"], **bd,
                    "library_ms": library[key], "staged_bound_ms": st["bound_ms"], "staged_bound_by": st["bound_by"],
                    # a count is one call of the C entry; the manual read's starts its ring kernel and its summing kernel
                    "kernels_per_launch": 2 if key == "manual_read" else 1,
                    "ms_by_leg": {n: r["ms_per_iter"] for n, r in legs.items() if n.startswith(prefix[key])}}
    return out


def smoke_audio(rng: np.random.Generator, batch: int, samples: int) -> np.ndarray:
    """Half loud tones over noise, half quiet noise: inputs far enough apart
    that a random res8 labels them differently, so some clips fire."""
    t = np.arange(samples) / SAMPLE_RATE
    freqs = rng.uniform(200.0, 4000.0, batch)[:, None]
    tones = 0.5 * np.sin(2 * np.pi * freqs * t[None, :])
    noise = rng.standard_normal((batch, samples))
    loud = np.arange(batch)[:, None] < batch // 2
    return np.where(loud, tones + 0.05 * noise, 0.002 * noise).astype(np.float32)


def firing_config(probs, base_cfg):
    """A one-word sequence on the loud half's most frequent top label, with
    the threshold midway between the quiet half's highest and the loud
    half's lowest peak posterior, so the batch splits."""
    half, num = probs.shape[0] // 2, probs.shape[-1]
    k = int(np.bincount(probs[:half].argmax(-1).ravel(), minlength=num).argmax())
    peak = probs.max(-1).max(-1)  # (B,) highest posterior of each clip
    quiet, loud = float(peak[half:].max()), float(peak[:half].min())
    if loud <= quiet:
        raise AssertionError(f"loud and quiet clips' peak posteriors overlap: {loud:.4f} <= {quiet:.4f}")
    print(f"firing config: word label {k}, threshold between peaks {quiet:.4f} and {loud:.4f}")
    return dataclasses.replace(
        base_cfg, inference_sequence=(k,), negative_label=(k + 1) % num,
        inference_threshold=(quiet + loud) / 2,
    )


def drive_main_path(dev, batch: int, clip_seconds: float) -> dict:
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    rng = np.random.default_rng(SEED + 1)
    num_labels = 4
    frontend = FrontendConfig(n_mels=N_MELS)
    base_cfg = EngineConfig(
        inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
        negative_label=3, num_labels=num_labels, sample_rate=SAMPLE_RATE,
    )
    model = create_model("res8", num_labels=num_labels)
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, num_labels))
    samples = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy(smoke_audio(rng, batch, samples)).to(dev)

    def engine(cfg, dtype):
        # both engines at the "bf16" frontend grade, so that the decision check holds the trunk's dtype alone
        return StreamingEngine(
            model, state, cfg, frontend, zmuv_mean=-6.0, zmuv_std=4.0, compute_dtype=dtype, frontend_precision="bf16",
            device=dev,
        )

    probe = engine(base_cfg, None).score_batch(audio)["probs"].cpu().numpy()
    cfg = firing_config(probe, base_cfg)
    f32, bf16 = engine(cfg, None), engine(cfg, torch.bfloat16)
    ref = f32.infer_batch(audio)

    # the exact grade's engine on K1's tensor-core kernel (six bf16 passes, the route it takes) against the same
    # engine with K1 forced onto the FMA kernel: the same decisions
    class FmaFrontendEngine(StreamingEngine):
        """The engine with K1 forced onto the FMA kernel."""

        def _features(self, audio, layout):
            return log_mel_spectrogram_cuda(audio, self.frontend, self.zmuv_mean, self.zmuv_std,
                                            precision=self.frontend_precision, out_dtype=torch.float32, layout=layout,
                                            route="fma")

    exact = {route: cls(model, state, cfg, frontend, zmuv_mean=-6.0, zmuv_std=4.0, frontend_precision="f32",
                        device=dev).infer_batch(audio) for route, cls in (("tc", StreamingEngine), ("fma", FmaFrontendEngine))}
    agree = {key: float((exact["tc"][key].cpu() == exact["fma"][key].cpu()).double().mean())
             for key in ("detected", "first_fire_step", "labels")}
    print(f"float32 engine at the exact grade, K1 'tc' against 'fma' ({int(exact['fma']['detected'].sum())}/{batch} "
          f"fire): detected {agree['detected']:.4f}, first fire {agree['first_fire_step']:.4f}, labels "
          f"{agree['labels']:.4f} agree; max |dprob| {float((exact['tc']['probs'] - exact['fma']['probs']).abs().max()):.3e}")
    if min(agree.values()) < 1.0:
        raise AssertionError("the float32 engine decides differently on K1's tensor-core kernel and on its FMA kernel")
    del exact

    log_mel_spectrogram_cuda.launches = 0
    log_mel_spectrogram_cuda.launches_tc = 0
    res8_stem_cuda.launches = 0
    res8_stem_cuda.launches_tc = 0
    out = bf16.infer_batch(audio)
    torch.cuda.synchronize()
    launches = {"k1": log_mel_spectrogram_cuda.launches, "k1_tc": log_mel_spectrogram_cuda.launches_tc,
                "k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc}
    print(f"main path launches: frontend kernel {launches['k1']} ({launches['k1_tc']} of them the tensor-core kernel), "
          f"stem kernel {launches['k2']} ({launches['k2_tc']} of them the tensor-core kernel)")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    if launches["k2"] != 1 or launches["k2_tc"] != 1:
        raise AssertionError(f"a bf16 batch must launch the tensor-core stem kernel once, and no other stem: {launches}")

    probs = out["probs"]
    n_win = bf16.n_windows(samples)
    if tuple(probs.shape) != (batch, n_win, num_labels) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"posteriors of shape {tuple(probs.shape)}, finite={bool(torch.isfinite(probs).all())}")
    if float((probs.sum(-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("posteriors do not sum to 1")
    fired = int(ref["detected"].sum())
    print(f"f32 engine: {fired}/{batch} clips fire on sequence {cfg.inference_sequence}")
    if not 0 < fired < batch:
        raise AssertionError("the decision check needs a batch where some clips fire and some do not")
    for key in ("detected", "first_fire_step", "labels"):
        if not torch.equal(out[key].cpu(), ref[key].cpu()):
            diff = int((out[key].cpu() != ref[key].cpu()).sum())
            raise AssertionError(f"bf16 {key} differ from the f32 engine's in {diff} places")
    prob_err = float((probs - ref["probs"]).abs().max())
    print(f"bf16 vs f32 engine: decisions equal; max |dprob| = {prob_err:.3e}")

    # the bench's chained timing: each batch's input bumped by the last detections
    runs = [bench.chained_batch_ms(bf16, audio, bench.CARD.iters) for _ in range(SMOKE_REPEATS)]
    batch_ms = float(np.median(runs))
    rtf = batch * clip_seconds / (batch_ms / 1000.0)
    print(f"main path: median {batch_ms:.3f} ms per batch of {batch} x {clip_seconds:g} s over {SMOKE_REPEATS} chains "
          f"of {bench.CARD.iters} ({', '.join(f'{m:.3f}' for m in runs)}); realtime factor {rtf:.1f}")
    return {"launches": launches, "batch_ms": batch_ms, "batch_ms_runs": runs, "realtime_factor": rtf}


def check_tf32_guard(dev, clips: int = 64, streams: int = ONLINE_STREAMS) -> None:
    """(9b) ROADMAP F13: the float32 paths do not follow the caller's global
    TF32 flags. With both flags on, then off, a float32 engine built with
    defaults scores ``clips`` clips of 8 s, and the ``OnlineEngine`` and the
    ``IncrementalOnlineEngine`` take one float32 hop of ``streams`` streams;
    each result must be bit for bit the same both times and the flags the
    caller's again after each call. The control: the same scorer without
    its guard must differ between the two settings. The flags go back off
    after the phase, as ``main`` set them."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_grade

    rng = np.random.default_rng(SEED + 9)
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, 4))
    cfg, frontend = bench.serving_config(), FrontendConfig(n_mels=N_MELS)
    audio = torch.from_numpy(smoke_audio(rng, clips, int(CLIP_SECONDS * SAMPLE_RATE))).to(dev)
    windows = torch.from_numpy(smoke_audio(rng, streams, 8000)).to(dev)
    eng = StreamingEngine(create_model("res8", num_labels=4), state, cfg, frontend, -6.0, 4.0, device=dev)
    if frontend_grade(eng.frontend_precision) != "f32":
        raise AssertionError(f"a float32 engine built with defaults serves {eng.frontend_precision!r}, not the exact grade")
    live, inc = (kind(create_model("res8", num_labels=4), state, cfg, frontend, -6.0, 4.0, num_streams=streams,
                      device=dev) for kind in (OnlineEngine, IncrementalOnlineEngine))
    unguarded = StreamingEngine._score.__wrapped__.__wrapped__  # under torch.no_grad, without exact_if_float32
    outs = {}
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
            probs = eng.score_batch(audio)["probs"]
            hop = live._step(windows, live._new_state(), 0.0)[3]
            ring = inc._step(windows[:, : inc.hop_samples].contiguous(), inc.tail, inc.mel_ring, inc.state, 0.0)[1]
            if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != (flag, flag):
                raise AssertionError("a float32 path left the caller's TF32 flags changed")
            with torch.no_grad():
                raw = unguarded(eng, audio, eng.n_windows(audio.shape[-1]))
            torch.cuda.synchronize()
            outs[flag] = (probs, hop, ring, raw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for name, on, off in zip(("engine scores", "online hop", "incremental ring"), outs[True], outs[False]):
        if not torch.equal(on, off):
            raise AssertionError(f"F13: the float32 {name} follow the caller's TF32 flags")
    control = float((outs[True][3] - outs[False][3]).abs().max())
    print(f"F13: float32 engine scores ({clips} x {CLIP_SECONDS:g} s), an OnlineEngine hop and an incremental hop "
          f"({streams} streams) bit for bit equal with the caller's TF32 on and off, flags restored; unguarded "
          f"scorer max |dprob| {control:.3e}")
    if control == 0.0:
        raise AssertionError("the TF32 flags changed nothing on the unguarded scorer: the check sees nothing")


def check_stem_on_windows(mel_tm, taps, chunk: int = 8192) -> float:
    """The stem kernel on the per-window scorer's (B * n_windows, 41, F)
    bf16 mels against its plain version, chunk by chunk (the plain version's
    float32 pre-pool activation of a whole batch would take ~18 GB): one bf16
    ulp of the output's magnitude."""
    import torch

    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain

    got = res8_stem_cuda(mel_tm, taps)
    err, tol = 0.0, 0.0
    for lo in range(0, mel_tm.shape[0], chunk):
        ref = res8_stem_plain(mel_tm[lo : lo + chunk], taps)
        part = got[lo : lo + chunk]
        if not bool(torch.isfinite(part.float()).all()):
            raise AssertionError("the stem kernel wrote a value that is not finite on the window batch")
        err, tol = max(err, float((part.float() - ref.float()).abs().max())), max(tol, _bf16_ulp(ref))
    print(f"K2 tc on the window batch {tuple(mel_tm.shape)} -> {tuple(got.shape)}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError("the stem kernel disagrees with its plain version on the window batch")
    return err


def drive_legacy_path(dev, batch: int, clip_seconds: float) -> dict:
    """The per-window mega-batch scorer (``fused_trunk=False``) at the bench's
    size, bf16 against the exact float32 engine on a batch that splits."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    rng = np.random.default_rng(SEED + 6)
    num_labels = 4
    frontend = FrontendConfig(n_mels=N_MELS)
    base_cfg = EngineConfig(
        inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
        negative_label=3, num_labels=num_labels, sample_rate=SAMPLE_RATE,
    )
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, num_labels))
    samples = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy(smoke_audio(rng, batch, samples)).to(dev)

    def engine(cfg, dtype):
        return StreamingEngine(create_model("res8", num_labels=num_labels), state, cfg, frontend, zmuv_mean=-6.0,
                               zmuv_std=4.0, compute_dtype=dtype, fused_trunk=False, frontend_precision="auto",
                               device=dev)

    cfg = firing_config(engine(base_cfg, None).score_batch(audio)["probs"].cpu().numpy(), base_cfg)
    f32, bf16 = engine(cfg, None), engine(cfg, torch.bfloat16)
    ref = f32.infer_batch(audio)
    for fn in (log_mel_spectrogram_cuda, res8_stem_cuda):
        fn.launches = fn.launches_tc = 0
    out = bf16.infer_batch(audio)
    torch.cuda.synchronize()
    launches = {"k1": log_mel_spectrogram_cuda.launches, "k1_tc": log_mel_spectrogram_cuda.launches_tc,
                "k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc}
    print(f"legacy path launches (one bf16 batch): frontend kernel {launches['k1']} ({launches['k1_tc']} the tensor-core "
          f"kernel), stem kernel {launches['k2']} ({launches['k2_tc']} the tensor-core kernel)")
    if launches["k1"] < 1 or launches["k2"] != 1 or launches["k2_tc"] != 1:
        raise AssertionError(f"a bf16 legacy batch must launch the frontend kernel and the tensor-core stem once: {launches}")

    probs, n_win = out["probs"], bf16.n_windows(samples)
    if tuple(probs.shape) != (batch, n_win, num_labels) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"legacy posteriors of shape {tuple(probs.shape)}, finite={bool(torch.isfinite(probs).all())}")
    if float((probs.sum(-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("legacy posteriors do not sum to 1")
    fired = int(ref["detected"].sum())
    print(f"legacy f32 engine: {fired}/{batch} clips fire on sequence {cfg.inference_sequence}; {n_win} windows a clip")
    if not 0 < fired < batch:
        raise AssertionError("the legacy decision check needs a batch where some clips fire and some do not")
    for key in ("detected", "first_fire_step", "labels"):
        if not torch.equal(out[key].cpu(), ref[key].cpu()):
            diff = int((out[key].cpu() != ref[key].cpu()).sum())
            raise AssertionError(f"legacy bf16 {key} differ from the legacy f32 engine's in {diff} places")
    print(f"legacy bf16 vs f32 engine: decisions equal; max |dprob| = {float((probs - ref['probs']).abs().max()):.3e}")

    # the stem kernel on the window batch the bf16 scorer gives it: 41-frame clips, 13 pooled frames in a tile of 24
    with torch.no_grad():
        feats = bf16._features(audio, "fm")
        idx = (torch.arange(n_win, device=dev) * bf16.stride_frames)[:, None] + torch.arange(bf16.window_frames, device=dev)
        mel_tm = feats[:, :, idx].permute(0, 2, 3, 1).reshape(-1, bf16.window_frames, N_MELS).contiguous()
        k2_err = check_stem_on_windows(mel_tm, bf16._stem_taps)
    del feats, mel_tm, out, ref
    torch.cuda.empty_cache()
    return {"launches": launches, "fired": fired, "k2_windows_max_abs_err": k2_err}


def drive_int8_path(dev, batch: int, clip_seconds: float) -> dict:
    """The JAX serving headline's precision ladder at 512 x 8 s, bf16: K1 "tc"
    at "bf16", K2 "tc", the int8 residual trunk (one launch of
    ``csrc/int8_trunk_fused.cu``), window pooling and the FSM, calibrated on
    the batch's first 64 clips as the bench builds it. Its launches, its
    posteriors, the fused kernel against the plain int8 trunk bit for bit on
    the batch's stem and on short, ragged and one-past-a-tile geometries in
    bf16 and float32, the layer kernel (route "layer": exact s32 sums, the
    trunk bit for bit), the engine's decisions against an engine on the
    plain int8 trunk and the float32 engine's, both int8 routes and cuDNN's
    bf16 stage 3 timed in turns, and the full-step A/B of the trunks that
    decides the bench's headline. Returns the fused and the layer kernel's
    records."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.int8_trunk import (
        FUSED_TILE_FRAMES, int8_conv_layer_cuda, int8_conv_sums_plain, int8_trunk_fused_cuda, int8_trunk_route,
        quantize_activations, residual_features_int8, residual_features_int8_plain,
    )
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda
    from howl_tpu_torch.tools import ablate_serving_slope

    rng = np.random.default_rng(SEED + 7)
    num_labels = 4
    frontend = FrontendConfig(n_mels=N_MELS)
    base_cfg = EngineConfig(
        inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
        negative_label=3, num_labels=num_labels, sample_rate=SAMPLE_RATE,
    )
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, num_labels))
    samples = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy(smoke_audio(rng, batch, samples)).to(dev)
    calibration = audio[: bench.CALIBRATION_CLIPS]

    def engine(cfg, dtype, **kw):
        return StreamingEngine(create_model("res8", num_labels=num_labels), state, cfg, frontend, zmuv_mean=-6.0,
                               zmuv_std=4.0, compute_dtype=dtype, device=dev, **kw)

    cfg = firing_config(engine(base_cfg, None, frontend_precision="f32").score_batch(audio)["probs"].cpu().numpy(),
                        base_cfg)
    ref = engine(cfg, None, frontend_precision="f32").infer_batch(audio)
    eng = engine(cfg, torch.bfloat16, frontend_precision="bf16", use_int8_trunk=True, int8_calibration_audio=calibration)
    p = eng._int8_params
    print(f"int8 trunk calibrated on {calibration.shape[0]} clips: act scales "
          f"{', '.join(f'{a:.5f}' for a in p.act_scale)}")

    def zero_counters():
        for fn in (log_mel_spectrogram_cuda, res8_stem_cuda):
            fn.launches = fn.launches_tc = 0
        int8_conv_layer_cuda.launches = int8_trunk_fused_cuda.launches = 0

    zero_counters()
    out = eng.infer_batch(audio)
    torch.cuda.synchronize()
    launches = {"k1": log_mel_spectrogram_cuda.launches, "k1_tc": log_mel_spectrogram_cuda.launches_tc,
                "k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc,
                "int8_fused": int8_trunk_fused_cuda.launches, "int8": int8_conv_layer_cuda.launches}
    print(f"int8 headline launches (one batch): frontend kernel {launches['k1']} ({launches['k1_tc']} tc), stem kernel "
          f"{launches['k2']} ({launches['k2_tc']} tc), fused int8 trunk {launches['int8_fused']}, int8 layer kernel "
          f"{launches['int8']}")
    if launches != {"k1": 1, "k1_tc": 1, "k2": 1, "k2_tc": 1, "int8_fused": 1, "int8": 0}:
        raise AssertionError(f"the int8 headline must launch K1 'tc', K2 'tc' and the fused int8 trunk once each and "
                             f"the int8 layer kernel never: {launches}")
    probs, n_win = out["probs"], eng.n_windows(samples)
    if tuple(probs.shape) != (batch, n_win, num_labels) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"int8 posteriors of shape {tuple(probs.shape)}, finite={bool(torch.isfinite(probs).all())}")
    if float((probs.sum(-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("int8 posteriors do not sum to 1")

    with torch.no_grad():
        s0 = eng._pooled_stem(audio)
        want = residual_features_int8_plain(s0, p, torch.bfloat16)
        got = residual_features_int8(s0, p, torch.bfloat16)  # the route the engine takes: fused
        torch.cuda.synchronize()
        fused_err = float((got.float() - want.float()).abs().max())
        fused_ok = torch.equal(got, want)
        print(f"fused int8 trunk vs plain on the batch's stem {tuple(s0.shape)}: max_abs_err={fused_err:.3e}, stated "
              f"bound 0 (exact sums, the same bf16 rounding points); finite={bool(torch.isfinite(got.float()).all())}")
        # the fused kernel at the geometries that show a tile or padding mistake, both dtypes where it serves them
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        cases, bad = 0, []
        for dtype in (torch.bfloat16, torch.float32):
            tt = FUSED_TILE_FRAMES[dtype]
            for n_f in (10, 8):
                if int8_trunk_route(dtype, n_f, s0.shape[3]) != "fused":
                    continue
                for b in (1, 3):
                    for t in (1, tt - 1, tt, tt + 1, 213):
                        y = (torch.randn((b, t, n_f, s0.shape[3]), generator=gen, device=dev) * 1.5).to(dtype)
                        cases += 1
                        if not torch.equal(int8_trunk_fused_cuda(y, p, dtype), residual_features_int8_plain(y, p, dtype)):
                            bad.append((str(dtype), b, t, n_f))
        print(f"fused int8 trunk vs plain on {cases} geometries (B 1 and 3; T 1, tile - 1, tile, tile + 1, 213; F 10 "
              f"and 8; bf16 tiles of {FUSED_TILE_FRAMES[torch.bfloat16]}, float32 of "
              f"{FUSED_TILE_FRAMES[torch.float32]}): {cases - len(bad)} bit for bit")
        if not fused_ok or bad:
            raise AssertionError(f"the fused int8 trunk disagrees with its plain version: batch equal {fused_ok}, {bad}")
        # the layer kernel, route "layer": the first layer's s32 sums through the kernel's interface (s8 values as
        # float32 activations, s_a = 1 and dq = 1 give relu(acc) exactly, the negated weights relu(-acc)), the trunk
        xq = quantize_activations(s0, p.act_scale[0])
        ones = torch.ones_like(p.w_scale[0])
        x = xq.float()
        sums = int8_conv_layer_cuda(x, p.w_i8[0], 1.0, ones)[0] - int8_conv_layer_cuda(x, -p.w_i8[0], 1.0, ones)[0]
        want_sums = int8_conv_sums_plain(xq, p.w_i8[0])
        sums_exact = torch.equal(sums.to(torch.int32), want_sums)
        del x, sums
        int8_conv_layer_cuda.launches = 0
        got_layer = residual_features_int8(s0, p, torch.bfloat16, route="layer")
        torch.cuda.synchronize()
        layer_launches = int8_conv_layer_cuda.launches
        layer_err = float((got_layer.float() - want.float()).abs().max())
        print(f"int8 layer kernel (route 'layer', {layer_launches} launches) vs plain: layer-1 s32 sums "
              f"exact={sums_exact} (|acc| up to {int(want_sums.abs().max())}); trunk max_abs_err={layer_err:.3e}")
        if not (sums_exact and torch.equal(got_layer, want) and layer_launches == 6):
            raise AssertionError("the int8 layer kernel disagrees with its plain version")
        del got_layer
        plain_out = eng._decide(eng._window_posteriors(want, n_win), eng._as_lengths(None, batch, samples),
                                eng._step_geometry(batch, samples))
    for key in ("detected", "first_fire_step", "labels"):
        if not torch.equal(out[key].cpu(), plain_out[key].cpu()):
            raise AssertionError(f"the int8 engine's {key} differ from the engine's on the plain int8 trunk")
    fired = int(ref["detected"].sum())
    agree = {key: float((out[key].cpu() == ref[key].cpu()).double().mean()) for key in ("detected", "first_fire_step", "labels")}
    print(f"int8 engine: decisions equal to the plain int8 trunk's; against the exact float32 engine ({fired}/{batch} "
          f"fire; random weights, for information): detected {agree['detected']:.4f}, first fire {agree['first_fire_step']:.4f}, "
          f"labels {agree['labels']:.4f} agree; max |dprob| {float((probs - ref['probs']).abs().max()):.3e}")

    # both int8 routes and cuDNN's bf16 stage 3 in turns (fused, layer, cudnn, layer, fused), the plain trunk beside
    with torch.no_grad():
        fns = {"fused": lambda: residual_features_int8(s0, p, torch.bfloat16, route="fused"),
               "layer": lambda: residual_features_int8(s0, p, torch.bfloat16, route="layer"),
               "cudnn": lambda: eng.model.residual_features(s0)}
        turns = [(who, _cuda_ms(fns[who], 10)) for who in ("fused", "layer", "cudnn", "layer", "fused")]
        ms = {who: float(np.mean([t for w, t in turns if w == who])) for who in fns}
        plain_ms = _cuda_ms(lambda: residual_features_int8_plain(s0, p, torch.bfloat16), 2)
    positions, ch = s0.shape[0] * s0.shape[1] * s0.shape[2], s0.shape[3]
    ops = 6 * 2 * positions * ch * 9 * ch
    weights = 6 * (9 * ch * ch + 3 * 4 * ch)  # the s8 weights and the per-channel vectors, read once
    # the fused trunk reads y and writes its output once; layers 1-6 of the layer kernel read and write 2, 4, 2,
    # 4, 2 and 3 activations
    fused = {"max_abs_err": fused_err, "ms": ms["fused"], "plain_ms": plain_ms, "cudnn_bf16_stage3_ms": ms["cudnn"],
             **_bound(2 * _nbytes(s0) + weights, ops, PEAK_INT8_OPS), "launches": launches["int8_fused"]}
    layer = {"max_abs_err": layer_err, "ms": ms["layer"], "plain_ms": plain_ms, "cudnn_bf16_stage3_ms": ms["cudnn"],
             **_bound(17 * _nbytes(s0) + weights, ops, PEAK_INT8_OPS), "launches": layer_launches}
    print(f"int8 trunk at {tuple(s0.shape)} bf16, in turns ({', '.join(f'{w} {t:.4f}' for w, t in turns)} ms): fused "
          f"kernel {ms['fused']:.4f} ms, {fused['bound_ms'] / ms['fused']:.3f} of its bound {fused['bound_ms']:.4f} ms "
          f"by {fused['bound_by']} ({fused['operations'] / 1e9:.2f} GOP, {fused['bytes'] / 1e6:.1f} MB); layer kernel "
          f"(six launches) {ms['layer']:.4f} ms, {layer['bound_ms'] / ms['layer']:.3f} of its bound "
          f"{layer['bound_ms']:.4f} ms by {layer['bound_by']}; cuDNN's bf16 stage 3 {ms['cudnn']:.4f} ms; plain "
          f"{plain_ms:.3f} ms")
    del s0, got, want, out, ref, eng
    torch.cuda.empty_cache()

    # the A/B that decides bench.HEADLINE_TRUNK: the serving ablation's full fused step, the bf16 trunk against the
    # int8 trunk on each route
    ab = ablate_serving_slope.trunk_ab(batch, clip_seconds, STUDY_ITERS, SEED, dev, turns=2)
    med = {who: float(np.median(v)) for who, v in ab.items()}
    verdict = "int8" if med["int8"] <= med["bf16"] else "bf16"
    print(f"full fused step A/B (two-point slope, in turns): bf16 trunk {', '.join(f'{m:.3f}' for m in ab['bf16'])} ms, "
          f"int8 trunk (fused) {', '.join(f'{m:.3f}' for m in ab['int8'])} ms, int8 trunk (layer) "
          f"{', '.join(f'{m:.3f}' for m in ab['int8_layer'])} ms; the {verdict} trunk is no slower here; the bench's "
          f"headline trunk is {bench.HEADLINE_TRUNK!r}")
    fused["ab_full_step_ms"] = ab
    torch.cuda.empty_cache()
    return {"fused": fused, "layer": layer}


def drive_int8_tools() -> None:
    """Both int8 tools at their JAX tools' sizes: the trunk legs at batch 512,
    the stream-step legs at (16,384, 1) and (65,536, 3) (at half the JAX
    tool's chain length, for the run's time)."""
    from howl_tpu_torch.tools import bench_stream_step_int8, bench_trunk_int8

    legs = bench_trunk_int8.main(["--batch", str(BATCH)])
    steps = bench_stream_step_int8.main(["--iters", str(STUDY_ITERS // 2)])  # chains of 8 and 32 steps, for time
    times = list(legs.values()) + [ms for geom in steps.values() for ms in geom.values()]
    if len(legs) != 3 or len(steps) != 2 or not all(np.isfinite(ms) and ms > 0 for ms in times):
        raise AssertionError(f"an int8 tool's leg is missing or not a positive time: {legs} {steps}")


def check_decision_gate(dev) -> None:
    """(11) The decision gate on the card: all fourteen rows must run and be
    OK, the three-pass grade's (on the tensor-core frontend kernel), the int8
    trunk's, the five other families' and lstm's live row among them, against an oracle whose
    exact grade runs on the tensor-core frontend kernel too (six bf16
    passes)."""
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route
    from howl_tpu_torch.tools import validate_tpu_decisions

    for grade in ("bf16x3", "f32"):
        if frontend_route(FrontendConfig(n_mels=40), grade) != "tc":
            raise AssertionError(f"the gate's {grade} engine would not run on the tensor-core frontend kernel")
    rows = validate_tpu_decisions.run(dev, *validate_tpu_decisions.CARD_SIZE)
    bad = [tag for tag, rec in rows.items() if rec["ok"] is not True]
    bad += [tag for tag in ("res8+k1[bf16x3]+k2", "res8+k1[bf16]+k2+int8", *validate_tpu_decisions.FAMILIES,
                            f"{validate_tpu_decisions.LIVE_FAMILY}+full-window[bf16]") if tag not in rows]
    if len(rows) != 14 or bad:
        raise AssertionError(f"the decision gate found a mismatch in {bad}")


# ---- the zoo's other families, served offline ----


def drive_families(dev) -> dict:
    """(11b) Each of the seven other families at its registered width, on
    seeded numpy weights carried across by ``compat`` (the gate's
    ``family_setup``: the weights fixed per family, the word and threshold
    picked from float32 scores, every decision 0.01 or more from flipping)
    and 512 clips of 8 s of the gate's ``family_audio`` (eight distinct
    clips, each 64 times): ``infer_batch`` in float32 (the
    frontend at "f32") and in bf16 (at "bf16"), through ``WholeClipEngine``
    for seq-lstm and seq-cnn; lstm and gru once more in bf16 with
    ``carry_windows``. Between zeroed counters each batch must launch K1
    once (las none: it featurizes through the plain stacked chain), on "tc"
    where ``frontend_route`` serves the grade; the posteriors must be
    finite; the bf16 decisions must equal float32's by the gate's rule.
    Prints each family's batch time (mean of ``FAMILY_ITERS`` after a
    warm-up) and realtime factor, and the recurrences' backend. Returns
    {name: record}."""
    import torch

    from howl_tpu_torch.bench import serving_config
    from howl_tpu_torch.models import model_spec
    from howl_tpu_torch.models.rnn import recurrence_backend
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route, log_mel_spectrogram_cuda
    from howl_tpu_torch.tools.validate_tpu_decisions import compare, family_audio, family_engine, family_setup

    print(bench.card_line())
    cfg, frontend = serving_config(), FrontendConfig(n_mels=N_MELS)
    audio = torch.from_numpy(family_audio(BATCH, int(CLIP_SECONDS * SAMPLE_RATE))).to(dev)
    out = {}
    for name in FAMILY_NAMES:
        spec = model_spec(name)
        state, fam_cfg, pick = family_setup(name, cfg, frontend, dev, audio)
        legs = [("f32", None, "f32", {}), ("bf16", torch.bfloat16, "bf16", {})]
        if spec.is_recurrent and not spec.is_sequential:
            legs.append(("bf16 carry_windows", torch.bfloat16, "bf16", {"carry_windows": True}))
        rec = {"seed": pick["seed"], "kernel_gain": pick["gain"], "word": pick["word"],
               "threshold": pick["threshold"], "distance": pick["distance"], "launches": {}, "ms": {}}
        results = {}
        for tag, dtype, grade, kw in legs:
            eng = family_engine(name, state, fam_cfg, frontend, dev, dtype, grade, **kw)
            eng.infer_batch(audio)  # warm-up: cuDNN's plans, the frontend's bases
            torch.cuda.synchronize()
            log_mel_spectrogram_cuda.launches = log_mel_spectrogram_cuda.launches_tc = 0
            res = eng.infer_batch(audio)
            torch.cuda.synchronize()
            launches = (log_mel_spectrogram_cuda.launches, log_mel_spectrogram_cuda.launches_tc)
            want = (0, 0) if spec.uses_deltas else (1, int(frontend_route(frontend, grade) == "tc"))
            if launches != want:
                raise AssertionError(f"{name} {tag}: K1 launched {launches} (all, tc) times in a batch, {want} expected")
            if not bool(torch.isfinite(res["probs"]).all()):
                raise AssertionError(f"{name} {tag}: posteriors that are not finite")
            rec["launches"][tag] = launches[0]
            rec["ms"][tag] = _cuda_ms(lambda: eng.infer_batch(audio), FAMILY_ITERS)
            results[tag] = res
        gate = compare(results["f32"], results["bf16"])
        dprob = float((results["bf16"]["probs"] - results["f32"]["probs"]).abs().max())
        rtf = BATCH * CLIP_SECONDS * 1000 / rec["ms"]["bf16"]
        backend = (f"; recurrences on {recurrence_backend(torch.empty(0, device=dev))} in float32, "
                   f"{recurrence_backend(torch.empty(0, device=dev, dtype=torch.bfloat16))} in bf16"
                   if spec.is_recurrent or spec.uses_deltas else "")
        print(f"{name}: seed {pick['seed']}, kernel gain {pick['gain']:.4f}, word {pick['word']}, threshold "
              f"{pick['threshold']:.4f} ({pick['distance']:.4f} from the nearest top posterior); "
              f"{int(results['f32']['detected'].sum())} of {BATCH} clips fire; K1 launches "
              f"{rec['launches']}; batch ms " + ", ".join(f"{k} {v:.3f}" for k, v in rec["ms"].items())
              + f"; bf16 realtime factor {rtf:.1f}; bf16 decisions equal float32's by the gate's rule {gate['ok']} "
              f"(detected {gate['detected_eq']}, first fire {gate['first_fire_eq']}, labels "
              f"{gate['label_agreement']:.4f}); max |dprob| {dprob:.3e}{backend}")
        if not gate["ok"]:
            raise AssertionError(f"{name}: the bf16 decisions differ from float32's: {gate}")
        out[name] = {**rec, "realtime_factor": rtf, "max_dprob": dprob}
    return out


# ---- the zoo's other families, served live ----


def _live_variants(spec) -> list:
    """(engine kind, carry_hops) of a family's live checks: the ``OnlineEngine``, the incremental engine (not for a
    model that reads deltas), and for a recurrent model the ``OnlineEngine`` once more with ``carry_hops``."""
    variants = [("full-window", False)] + ([] if spec.uses_deltas else [("incremental", False)])
    return variants + ([("full-window", True)] if spec.is_recurrent else [])


def drive_families_live(dev, streams: int = ONLINE_STREAMS, hops: int = FAMILY_LIVE_HOPS) -> dict:
    """(11c) Each of the seven other families at its registered width on the live engines, ``streams`` streams of
    the gate's ``family_audio`` (eight distinct streams, each ``streams / 8`` times), a window and ``hops - 1`` hops
    of it: the ``OnlineEngine`` on its ``hops`` whole windows, the ``IncrementalOnlineEngine`` (not las) on every
    hop of it (``hops`` + 7), and, for lstm,
    seq-lstm and gru, the ``OnlineEngine`` with ``carry_hops``; each in float32 (K1 at "f32") and in bf16 (K1 at
    "bf16"), on the weights of ``FAMILY_WEIGHTS`` at the word and threshold ``family_live_setup`` picks from the
    float32 engine's per-hop posteriors. Between zeroed counters an ``OnlineEngine`` must launch K1 once a hop ("tc"
    where ``frontend_route`` serves the grade), las none (its stacked chain), and the incremental engine none; the
    bf16 fire flags and labels must equal float32's at every hop by the gate's live rule, and the posteriors be
    finite. Prints each family's hop ms (the mean over the hops, host clock: each hop reads its decisions back).
    Returns {family: record}."""
    import torch

    from howl_tpu_torch.models import model_spec
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route, log_mel_spectrogram_cuda
    from howl_tpu_torch.tools.validate_tpu_decisions import (
        compare_online, drive_live, family_audio, family_live_engine, family_live_setup,
    )

    print(bench.card_line())
    cfg, frontend = bench.serving_config(), FrontendConfig(n_mels=N_MELS)
    hop, window = int(cfg.eval_stride_size_ms / 1000 * SAMPLE_RATE), int(cfg.max_window_size_ms / 1000 * SAMPLE_RATE)
    audio = torch.from_numpy(family_audio(streams, window + (hops - 1) * hop)).to(dev)
    out = {}
    for name in FAMILY_NAMES:
        spec = model_spec(name)
        rec = {"launches": {}, "hop_ms": {}}
        for kind, carry in _live_variants(spec):
            tag = f"{kind}{' carry_hops' if carry else ''}"
            state, fam_cfg, pick = family_live_setup(name, kind, cfg, frontend, dev, audio, True, carry_hops=carry)
            runs = {}
            for grade, dtype in (("f32", None), ("bf16", torch.bfloat16)):
                eng = family_live_engine(name, kind, state, fam_cfg, frontend, dev, dtype, grade, num_streams=streams,
                                         carry_hops=carry)
                drive_live(eng, audio[:, : window + hop], True)  # the warm-up: cuDNN's plans, the frontend's bases
                eng.reset()
                log_mel_spectrogram_cuda.launches = log_mel_spectrogram_cuda.launches_tc = 0
                t0 = time.perf_counter()
                runs[grade] = drive_live(eng, audio, True)
                n_hops = runs[grade][0].shape[0]
                rec["hop_ms"][f"{tag} {grade}"] = (time.perf_counter() - t0) * 1000 / n_hops
                launches = (log_mel_spectrogram_cuda.launches, log_mel_spectrogram_cuda.launches_tc)
                per_hop = int(kind == "full-window" and not spec.uses_deltas)
                want = (per_hop * n_hops, per_hop * n_hops * int(frontend_route(frontend, grade) == "tc"))
                if launches != want:
                    raise AssertionError(f"{name} {tag} {grade}: K1 launched {launches} (all, tc) times in {n_hops} "
                                         f"hops, {want} expected")
                if not np.isfinite(runs[grade][2]).all():
                    raise AssertionError(f"{name} {tag} {grade}: posteriors that are not finite")
                rec["launches"][f"{tag} {grade}"] = launches[0]
            gate = compare_online(runs["f32"][:2], runs["bf16"][:2])
            fired = int(runs["f32"][0].any(0).sum())
            print(f"{name} live, {tag}: word {pick['word']}, threshold {pick['threshold']:.4f} ({pick['distance']:.4f} "
                  f"from the nearest top posterior, margin {pick['margin']:.4f}); {fired} of {streams} streams fire; "
                  f"K1 launches f32 {rec['launches'][f'{tag} f32']}, bf16 {rec['launches'][f'{tag} bf16']} in {n_hops} hops; "
                  f"hop ms f32 {rec['hop_ms'][f'{tag} f32']:.3f}, bf16 {rec['hop_ms'][f'{tag} bf16']:.3f}; bf16 fire "
                  f"flags equal float32's {gate['fired_eq']}, labels agree {gate['label_agreement']:.4f}; max |dprob| "
                  f"{float(np.abs(runs['bf16'][2] - runs['f32'][2]).max()):.3e}")
            if not gate["ok"]:
                raise AssertionError(f"{name} live, {tag}: the bf16 decisions differ from float32's: {gate}")
        out[name] = rec
    return out


# ---- live serving: the three online engines ----


def _live_engine(kind: str, dev, state, cfg, dtype, streams: int, **kw):
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    cls = {"full-window": OnlineEngine, "incremental": IncrementalOnlineEngine, "trunk": FusedStreamingOnlineEngine}
    return cls[kind](create_model("res8", num_labels=4), state, cfg, FrontendConfig(n_mels=N_MELS), ONLINE_ZMUV[0],
                     ONLINE_ZMUV[1], num_streams=streams, compute_dtype=dtype, device=dev, **kw)


def drive_online_path(dev) -> dict:
    """(a) The ``OnlineEngine`` at 512 streams in bf16, ``ONLINE_STEPS``
    hops between zeroed counters: one launch of K1's tensor-core kernel and
    one of K2's a hop. Then K1 ("fm", the "bf16" grade, bf16 out) on the
    (512, 8,000) windows and K2 on their (512, 41, 40) mels, each held
    against its plain version within ``check_frontend``'s and
    ``check_stem``'s bounds and timed against it in turns."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda, log_mel_spectrogram_plain
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain

    rng = np.random.default_rng(SEED + 7)
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, 4))
    eng = _live_engine("full-window", dev, state, bench.serving_config(), torch.bfloat16, ONLINE_STREAMS)
    hop, window = eng.hop_samples, eng.window_samples
    audio = torch.from_numpy(smoke_audio(rng, ONLINE_STREAMS, window + ONLINE_STEPS * hop)).to(dev)
    eng.ingest(audio[:, :window])  # the warm-up
    for fn in (log_mel_spectrogram_cuda, res8_stem_cuda):
        fn.launches = fn.launches_tc = 0
    for k in range(ONLINE_STEPS):
        eng.ingest(audio[:, k * hop : k * hop + window])
    torch.cuda.synchronize()
    launches = {"k1": log_mel_spectrogram_cuda.launches, "k1_tc": log_mel_spectrogram_cuda.launches_tc,
                "k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc}
    print(f"online path (OnlineEngine, {ONLINE_STREAMS} streams, bf16, {ONLINE_STEPS} hops) launches: frontend kernel "
          f"{launches['k1']} ({launches['k1_tc']} the tensor-core kernel), stem kernel {launches['k2']} "
          f"({launches['k2_tc']} the tensor-core kernel)")
    if set(launches.values()) != {ONLINE_STEPS}:
        raise AssertionError(f"a hop must launch the tensor-core frontend and stem kernels once each: {launches}")

    mean, std = ONLINE_ZMUV
    windows = audio[:, :window].contiguous()
    kw = dict(precision="bf16", out_dtype=torch.bfloat16, layout="fm")
    mel = log_mel_spectrogram_cuda(windows, eng.frontend, mean, std, **kw)
    ref = log_mel_spectrogram_plain(windows, eng.frontend, mean, std, **kw)
    torch.cuda.synchronize()
    k1_err, k1_tol = float((mel.float() - ref.float()).abs().max()), 2e-2 / std + _bf16_ulp(ref)
    print(f"K1 tc on the online windows {tuple(windows.shape)} -> {tuple(mel.shape)} (fm): max_abs_err={k1_err:.3e} "
          f"tol={k1_tol:.3e}")
    if mel.shape != ref.shape or not k1_err <= k1_tol:
        raise AssertionError("K1 disagrees with its plain version on the online windows")
    k1_ms, k1_plain_ms = _ab_ms(lambda: log_mel_spectrogram_plain(windows, eng.frontend, mean, std, **kw),
                                lambda: log_mel_spectrogram_cuda(windows, eng.frontend, mean, std, **kw), iters=50)
    fe = eng.frontend
    frames, n_bins = mel.shape[0] * mel.shape[2], fe.n_fft // 2
    k1_ops = frames * (2 * fe.n_fft * 2 * n_bins + 3 * n_bins + 2 * n_bins * fe.n_mels)
    k1 = {"shape": list(windows.shape), "launches": launches["k1_tc"], "max_abs_err": k1_err, "ms": k1_ms,
          "plain_ms": k1_plain_ms,
          **_bound(_nbytes(windows, mel) + 4 * (fe.n_fft * 2 * n_bins + n_bins * fe.n_mels), k1_ops, PEAK_BF16_FLOPS)}
    # a 128-frame tile holds a window's 41 frames: 87 of 128 rows of every product are empty
    print(f"K1 online case: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms a hop; bound {k1['bound_ms']:.4f} ms by "
          f"{k1['bound_by']}: {k1['bound_ms'] / k1_ms:.3f} of the bound's rate; frames fill "
          f"{mel.shape[2] / 128:.3f} of a tile")

    mel_tm = mel.transpose(1, 2).contiguous()
    got, ref = res8_stem_cuda(mel_tm, eng._stem_taps), res8_stem_plain(mel_tm, eng._stem_taps)
    torch.cuda.synchronize()
    k2_err, k2_tol = float((got.float() - ref.float()).abs().max()), _bf16_ulp(ref)
    print(f"K2 tc on the online windows {tuple(mel_tm.shape)} -> {tuple(got.shape)}: max_abs_err={k2_err:.3e} "
          f"tol={k2_tol:.3e}")
    if got.shape != ref.shape or not k2_err <= k2_tol:
        raise AssertionError("K2 disagrees with its plain version on the online windows")
    k2_ms, k2_plain_ms = _ab_ms(lambda: res8_stem_plain(mel_tm, eng._stem_taps),
                                lambda: res8_stem_cuda(mel_tm, eng._stem_taps), iters=50)
    k2_ops = mel_tm.numel() * got.shape[-1] * 9 * 2 + got.numel() * 12
    k2 = {"shape": list(mel_tm.shape), "launches": launches["k2_tc"], "max_abs_err": k2_err, "ms": k2_ms,
          "plain_ms": k2_plain_ms, **_bound(_nbytes(mel_tm, eng._stem_taps, got), k2_ops, PEAK_BF16_FLOPS)}
    print(f"K2 online case: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms a hop; bound {k2['bound_ms']:.5f} ms by "
          f"{k2['bound_by']}: {k2['bound_ms'] / k2_ms:.3f} of the bound's rate")
    return {"launches": launches, "k1": k1, "k2": k2}


def drive_incremental_at_scale(dev) -> dict:
    """(b) The ``IncrementalOnlineEngine`` at 65,536 streams in bf16 for
    ``BIG_STEPS`` hops: K2's tensor-core kernel launches once a hop on
    65,536 clips of 41 frames, and on the engine's last window batch it
    agrees with its plain version chunk by chunk."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(SEED + 8), 4))
    eng = _live_engine("incremental", dev, state, bench.serving_config(), torch.bfloat16, BIG_STREAMS)
    audio = torch.randn((BIG_STREAMS, BIG_STEPS * eng.hop_samples), generator=torch.Generator(device=dev).manual_seed(8),
                        device=dev) * 0.1
    res8_stem_cuda.launches = res8_stem_cuda.launches_tc = 0
    for k in range(BIG_STEPS):
        eng.push(audio[:, k * eng.hop_samples : (k + 1) * eng.hop_samples])
    torch.cuda.synchronize()
    launches = {"k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc}
    print(f"incremental engine at {BIG_STREAMS} streams, {BIG_STEPS} hops: stem kernel {launches['k2']} launches "
          f"({launches['k2_tc']} the tensor-core kernel), {BIG_STREAMS} clips each; labels {eng.last_labels.shape}")
    if launches != {"k2": BIG_STEPS, "k2_tc": BIG_STEPS}:
        raise AssertionError(f"a hop at {BIG_STREAMS} streams must launch the tensor-core stem kernel once: {launches}")
    with torch.no_grad():
        mel_tm = eng.mel_ring.transpose(1, 2).to(torch.bfloat16).contiguous()  # (65536, 41, 40), the last hop's windows
        err = check_stem_on_windows(mel_tm, eng._stem_taps)
        out = res8_stem_cuda(mel_tm, eng._stem_taps)
        ms = _cuda_ms(lambda: res8_stem_cuda(mel_tm, eng._stem_taps), 20)
    ops = mel_tm.numel() * out.shape[-1] * 9 * 2 + out.numel() * 12
    rec = {"shape": list(mel_tm.shape), "launches": launches["k2_tc"], "max_abs_err": err, "ms": ms,
           **_bound(_nbytes(mel_tm, eng._stem_taps, out), ops, PEAK_BF16_FLOPS)}
    print(f"K2 at {BIG_STREAMS} clips: kernel {ms:.4f} ms; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}: "
          f"{rec['bound_ms'] / ms:.3f} of the bound's rate")
    del eng, audio, mel_tm, out
    torch.cuda.empty_cache()
    return rec


def live_config(probs: list, base):
    """A one-word configuration on float32 per-hop posteriors (arrays (T, N,
    L) of the streams: the engine's and the offline scorer's) that fires on
    the loud half of the streams, every decision ``LIVE_MARGIN`` from
    flipping (``validate_tpu_decisions.margin_word_threshold``)."""
    from howl_tpu_torch.tools.validate_tpu_decisions import margin_word_threshold

    pick = margin_word_threshold(np.concatenate(probs), LIVE_MARGIN)
    print(f"live config: word label {pick['word']}, threshold {pick['threshold']:.4f}, every posterior at least "
          f"{pick['distance']:.4f} from it")
    return dataclasses.replace(base, inference_sequence=(pick["word"],), negative_label=(pick["word"] + 1) % 4,
                               inference_threshold=pick["threshold"])


def _live_run(kind: str, eng, audio) -> tuple:
    """Push ``audio`` through a live engine hop by hop ("full-window": the
    whole windows at every hop's start, k * hop); per hop (labels, fire
    flags, float32 posteriors), each (hops, streams[, L])."""
    step = eng.hop_samples * getattr(eng, "hop_block", 1)  # a push's samples
    first = eng.window_samples if kind == "full-window" else step
    out = []
    for end in range(first, audio.shape[1] + 1, eng.hop_samples if kind == "full-window" else step):
        if kind == "full-window":
            eng.ingest(audio[:, end - eng.window_samples : end])
        else:
            eng.push(audio[:, end - step : end])
        probs = (eng.last_probs if kind == "trunk" else eng.state.pred_ring[:, -1]).float().cpu().numpy()
        labels, fired = eng.last_labels, eng.last_fired
        if labels.ndim == 1:
            probs, labels, fired = probs[:, None], labels[:, None], fired[:, None]
        for h in range(labels.shape[1]):
            out.append((labels[:, h], fired[:, h], probs[:, h]))
    return tuple(np.stack(x) for x in zip(*out))


def check_live_decisions(dev) -> dict:
    """(c) Each live engine at 512 streams on audio whose loud half fires:
    bf16 decisions equal float32's at every hop, and every hop's decisions
    equal the offline ``StreamingEngine``'s on the same streams: the
    per-window scorer (``fused_trunk=False``) for the two per-window engines
    (the incremental one fed the stream from its 200th sample, so that its
    ring holds the scorer's window n - 8 after push n; its fire flags
    compared once the startup hops are out of the FSM's 2 s), and the fused
    scorer on the silent preroll + the hops for the trunk engine, per hop
    and blocked, each window ``lag`` hops late."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    rng = np.random.default_rng(SEED + 9)
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, 4))
    base = bench.serving_config()
    audio = torch.from_numpy(smoke_audio(rng, ONLINE_STREAMS, LIVE_SAMPLES)).to(dev)
    hops = audio[:, : LIVE_SAMPLES // 1000 * 1000]  # the trunk's hops: 63, a multiple of its period
    preroll = torch.zeros((ONLINE_STREAMS, 8200), device=dev)

    def offline(cfg, fused):
        return StreamingEngine(create_model("res8", num_labels=4), state, cfg, FrontendConfig(n_mels=N_MELS),
                               *ONLINE_ZMUV, fused_trunk=fused, frontend_precision="auto", device=dev)

    window_out = offline(base, False).infer_batch(audio)  # the per-window scorer's windows k * 1000 + [0, 8000)
    fused_out = offline(base, True).infer_batch(torch.cat([preroll, hops], 1))
    result = {}
    for kind in ("full-window", "incremental", "trunk"):
        feed = audio[:, 200:] if kind == "incremental" else hops if kind == "trunk" else audio
        probe_engine = _live_engine(kind, dev, state, base, None, ONLINE_STREAMS)
        probe = _live_run(kind, probe_engine, feed)[2]
        ref_probs = (fused_out if kind == "trunk" else window_out)["probs"].cpu().numpy().transpose(1, 0, 2)
        cfg = live_config([probe, ref_probs], base)
        ref = offline(cfg, kind == "trunk").infer_batch(torch.cat([preroll, hops], 1) if kind == "trunk" else audio)
        ref_labels, ref_fired = (ref[key].cpu().numpy().T for key in ("labels", "fired"))  # (windows, streams)
        variants = [("per-hop", {})] + ([("blocked", {"hop_block": 3})] if kind == "trunk" else [])
        for variant, kw in variants:
            tag = f"{kind} {variant}" if kind == "trunk" else kind
            f32, b16 = (_live_run(kind, _live_engine(kind, dev, state, cfg, dtype, ONLINE_STREAMS, **kw), feed)
                        for dtype in (None, torch.bfloat16))
            for name, a, b in (("labels", f32[0], b16[0]), ("fire flags", f32[1], b16[1])):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{tag}: bf16 {name} differ from float32's in {int((a != b).sum())} places")
            # entry i of the engine's run against window k of the offline scorer
            n = f32[0].shape[0]
            if kind == "full-window":
                pairs, fire_from = [(i, i) for i in range(n)], 0
            elif kind == "incremental":
                pairs, fire_from = [(i, i - 7) for i in range(8, n)], 1 + 31  # push i + 1 holds window i - 7
            else:
                lag = probe_engine.schedule.lag  # push i + 1 decides window i + 1 - lag
                pairs = [(i, i + 1 - lag) for i in range(lag - 1, n) if i + 1 - lag < n - lag - 2]
                fire_from = 0  # the offline scorer's last windows clamp their spans at the clip's edge: left out
            hop_idx, win_idx = (np.array(x) for x in zip(*pairs))
            labels_eq = np.array_equal(f32[0][hop_idx], ref_labels[win_idx])
            keep = win_idx >= fire_from
            fired_eq = np.array_equal(f32[1][hop_idx[keep]], ref_fired[win_idx[keep]])
            dprob = float(np.abs(f32[2][hop_idx] - ref_probs[win_idx]).max())
            detected = f32[1].any(0)
            print(f"{tag}: bf16 decisions equal float32's over {n} hops (max |dprob| "
                  f"{float(np.abs(b16[2] - f32[2]).max()):.3e}); against the offline scorer on {len(pairs)} windows: "
                  f"labels equal {labels_eq}, fire flags equal {fired_eq} (from window {fire_from}), max |dprob| "
                  f"{dprob:.3e}; {int(detected.sum())}/{ONLINE_STREAMS} streams fire")
            if not (labels_eq and fired_eq):
                raise AssertionError(f"{tag}: per-hop decisions differ from the offline scorer's")
            if not 0 < detected.sum() < ONLINE_STREAMS:
                raise AssertionError(f"{tag}: the check needs streams that fire and streams that do not")
            result[tag] = {"hops": n, "windows": len(pairs), "fired": int(detected.sum()), "dprob_offline": dprob}
    return result


def train_audio(rng: np.random.Generator, batch: int, samples: int):
    """Tones in three frequency bands take labels 0-2 and quiet noise takes
    label 3: data whose labels a res8 learns within a few steps."""
    labels = rng.integers(0, 4, batch)
    t = np.arange(samples) / SAMPLE_RATE
    bands = np.array([(200.0, 500.0), (800.0, 1600.0), (2500.0, 5000.0)])
    lo, hi = bands[np.minimum(labels, 2)].T
    freqs = rng.uniform(lo, hi)[:, None]
    tones = 0.5 * np.sin(2 * np.pi * freqs * t[None, :] + rng.uniform(0.0, 2 * np.pi, (batch, 1)))
    noise = rng.standard_normal((batch, samples))
    audio = np.where(labels[:, None] < 3, tones + 0.02 * noise, 0.002 * noise)
    return audio.astype(np.float32), labels


def _train_setup(dev):
    """The bench's train configuration (``bench.train_setup``) on tone data
    whose labels a res8 learns within a few steps."""
    audio, labels = train_audio(np.random.default_rng(SEED + 3), TRAIN_BATCH, TRAIN_WINDOW)
    return bench.train_setup(dev, audio, labels, BANK_SHAPE, SEED + 4)


def _to(draws, dev):
    """A step's draws (nested named tuples of tensors) on ``dev``."""
    import torch

    if isinstance(draws, torch.Tensor):
        return draws.to(dev)
    if isinstance(draws, tuple):
        return type(draws)(*(_to(d, dev) for d in draws))
    return draws


def check_train_step_against_cpu(dev) -> None:
    """One float32 train step with the bank on the card and on the CPU, from
    the same variables, data and draws: the loss within 1e-4 relative and
    every gradient within 1e-3 relative L2 (cuDNN and the CPU sum in other
    orders)."""
    import torch

    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.augment import AugmentConfig, prepare_noise_bank
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import StepConfig, draw_step, make_classification_train_step

    rng = np.random.default_rng(SEED + 5)
    variables = bench.res8_numpy_variables(rng, 4)
    audio, labels = (torch.from_numpy(x) for x in train_audio(rng, 16, TRAIN_WINDOW))
    bank = torch.from_numpy((rng.standard_normal((4, 9000)) * 0.05).astype(np.float32))
    cfg = StepConfig(FrontendConfig(n_mels=N_MELS), -0.5, 2.0, augment=AugmentConfig(), replace_prob=0.3,
                     negative_label=3, use_deltas=False)
    draws = draw_step(torch.Generator().manual_seed(SEED), cfg, 16, TRAIN_WINDOW, prepare_noise_bank(bank, TRAIN_WINDOW))
    out = {}
    for where in ("cpu", dev):
        model = create_model("res8", num_labels=4)
        state = create_train_state(model, 0.01, variables=variables, device=where)
        step = make_classification_train_step(model, cfg, bank.to(where))
        _, metrics = step(state, audio.to(where), labels.to(where), None, SEED, draws=_to(draws, where))
        out[str(where)] = (float(metrics["loss"]), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (cpu_loss, cpu_grads), (loss, grads) = out["cpu"], out[str(dev)]
    grad_err = max(float((grads[k] - g).norm() / g.norm()) for k, g in cpu_grads.items())
    print(f"float32 train step, card vs CPU on the same draws (batch 16): loss {loss:.6f} vs {cpu_loss:.6f}, "
          f"largest relative gradient error {grad_err:.3e}")
    if not (abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss) and grad_err <= 1e-3):
        raise AssertionError("the train step on the card disagrees with the CPU reference")


def drive_train_path(dev) -> dict:
    import torch

    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda
    from howl_tpu_torch.training.state import param_count
    from howl_tpu_torch.training.step import make_classification_eval_step, make_classification_train_step

    audio, labels, bank, cfg, state_for = _train_setup(dev)
    model, state = state_for(torch.bfloat16)
    print(f"train step: res8 {param_count(state)} params, batch {tuple(audio.shape)}, zmuv {cfg.zmuv_mean:.4f} / {cfg.zmuv_std:.4f}")
    noise_step = make_classification_train_step(model, cfg, bank)
    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    grad_seen = dict.fromkeys((name for name, _ in model.named_parameters()), False)
    losses = []
    k2_before = res8_stem_cuda.launches
    mix_noise_bank_cuda.launches = 0
    for _ in range(TRAIN_STEPS):
        state, metrics = noise_step(state, audio, labels, None, SEED)
        losses.append(float(metrics["loss"]))
        for name, p in model.named_parameters():
            grad_seen[name] |= bool(p.grad is not None and bool((p.grad != 0).any()))
    torch.cuda.synchronize()
    k3 = mix_noise_bank_cuda.launches
    print(f"train path launches: noise-bank mix kernel {k3} in {TRAIN_STEPS} steps; stem kernel {res8_stem_cuda.launches - k2_before}")
    print("bf16 losses: " + " ".join(f"{x:.4f}" for x in losses))
    if k3 != TRAIN_STEPS:
        raise AssertionError(f"the mix kernel launched {k3} times in {TRAIN_STEPS} steps")
    if res8_stem_cuda.launches != k2_before:
        raise AssertionError("a train step went through the stem kernel, which has no backward")
    if not np.isfinite(losses).all():
        raise AssertionError("a train step's loss is not finite")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 5 steps {first:.4f}, last 5 {last:.4f}")
    if not all(grad_seen.values()):
        raise AssertionError(f"parameters that never got a nonzero gradient: {[k for k, v in grad_seen.items() if not v]}")
    moved = {k: bool((model.state_dict()[k] != v).any()) for k, v in stats0.items()}
    if not all(moved.values()):
        raise AssertionError(f"BatchNorm running stats that did not move: {[k for k, v in moved.items() if not v]}")
    logits = make_classification_eval_step(model, cfg)(state, audio)
    if tuple(logits.shape) != (TRAIN_BATCH, 4) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"eval logits of shape {tuple(logits.shape)}, finite={bool(torch.isfinite(logits).all())}")
    eval_acc = float((logits.argmax(-1) == labels).float().mean())
    print(f"loss mean of the first 5 steps {first:.4f}, of the last 5 {last:.4f}; all {len(grad_seen)} parameters got "
          f"gradients (conv0 included); running stats moved; eval accuracy on the batch {eval_acc:.4f}")

    f32_model, f32_state = state_for(None)
    f32_state, metrics = make_classification_train_step(f32_model, cfg, bank)(f32_state, audio, labels, None, SEED)
    f32_loss = float(metrics["loss"])
    print(f"float32 step with the bank: loss {f32_loss:.4f}")
    if not np.isfinite(f32_loss):
        raise AssertionError("the float32 step's loss is not finite")

    # the bench's three steps (bf16 without and with the bank, float32), chains of its 64 steps in turns
    steps = bench.train_steps(model, f32_model, cfg, bank)
    states = {key: f32_state if key.endswith("_f32") else state for key in steps}
    runs = bench.time_train_steps(steps, states, audio, labels, bench.CARD.train_steps, SMOKE_REPEATS)
    rates = {}
    for key, ms in runs.items():
        per_run = [TRAIN_BATCH / (m / 1000.0) for m in ms]
        rates[key], rates[f"{key}_spread"] = float(np.median(per_run)), [min(per_run), max(per_run)]
        print(f"{key}: median {rates[key]:.1f} over {SMOKE_REPEATS} chains of {bench.CARD.train_steps} steps "
              f"(ms per step of {TRAIN_BATCH}: {', '.join(f'{m:.3f}' for m in ms)})")
    return {"k3_launches": k3, "losses": losses, "eval_accuracy": eval_acc, **rates}


def write_tone_corpus(root, n_positive: int, n_negative: int, seconds: float = 2.0):
    """A howl-format aligned corpus (``audio/*.wav`` + ``aligned-metadata-{training,dev,test}.jsonl``),
    as ``tests/fixtures.py``'s ``make_wakeword_corpus`` writes it: positives say "hey fire fox" as three
    0.3 s tone bursts, a carrier a word, with per-character end timestamps; negatives are noise."""
    from pathlib import Path

    from howl_tpu_torch.utils.audio_utils import write_wav

    root = Path(root)
    (root / "audio").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    vocab = ("hey", "fire", "fox")
    freqs = {w: 500.0 * (i + 1) for i, w in enumerate(vocab)}
    records = {"training": [], "dev": [], "test": []}
    split_of = lambda i: "training" if i % 4 < 2 else ("dev", "test")[i % 2]  # noqa: E731
    n_samples, word_dur = int(seconds * SAMPLE_RATE), 0.3
    for i in range(n_positive):
        audio = 0.01 * rng.standard_normal(n_samples).astype(np.float32)
        ends, cursor = [], 0.2 + 0.1 * rng.random()
        for w_idx, w in enumerate(vocab):
            start, dur = int(cursor * SAMPLE_RATE), int(word_dur * SAMPLE_RATE)
            audio[start : start + dur] += 0.3 * np.sin(2 * np.pi * freqs[w] * np.arange(dur) / SAMPLE_RATE).astype(np.float32)
            word_ms = (cursor * 1000, (cursor + word_dur) * 1000)
            ends += [word_ms[0] + (k + 1) * (word_ms[1] - word_ms[0]) / len(w) for k in range(len(w))]
            if w_idx < len(vocab) - 1:
                ends.append(ends[-1])  # the space takes the previous character's timestamp
            cursor += word_dur + 0.15
        write_wav(root / "audio" / f"pos_{i:03d}.wav", audio, SAMPLE_RATE)
        records[split_of(i)].append({"path": f"pos_{i:03d}.wav", "transcription": " ".join(vocab), "end_timestamps": ends})
    for i in range(n_negative):
        write_wav(root / "audio" / f"neg_{i:03d}.wav", 0.05 * rng.standard_normal(n_samples).astype(np.float32), SAMPLE_RATE)
        text = "something else entirely"
        records[split_of(i)].append({"path": f"neg_{i:03d}.wav", "transcription": text,
                                     "end_timestamps": list(np.linspace(10.0, seconds * 1000 - 10.0, len(text)))})
    for split, recs in records.items():
        (root / f"aligned-metadata-{split}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    return root


def write_noise_dir(root, n: int = 12, seconds: float = 3.0):
    """``tests/fixtures.py``'s ``make_noise_dir``: n clips of white noise."""
    from pathlib import Path

    from howl_tpu_torch.utils.audio_utils import write_wav

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        write_wav(root / f"noise_{i}.wav", 0.1 * rng.standard_normal(int(seconds * SAMPLE_RATE)).astype(np.float32), SAMPLE_RATE)
    return root


def _zero_launch_counts() -> None:
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    for fn in (mix_noise_bank_cuda, log_mel_spectrogram_cuda, res8_stem_cuda):
        fn.launches = 0
    log_mel_spectrogram_cuda.launches_tc = res8_stem_cuda.launches_tc = 0


def _launch_counts() -> dict:
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    return {"k1": log_mel_spectrogram_cuda.launches, "k1_tc": log_mel_spectrogram_cuda.launches_tc,
            "k2": res8_stem_cuda.launches, "k2_tc": res8_stem_cuda.launches_tc, "k3": mix_noise_bank_cuda.launches}


def _train_entry(argv: list, what: str, k1: bool = True, k2: bool = True) -> tuple[dict, dict, object]:
    """One call of the entry point between zeroed launch counts: (results, counts, the run's loop stats).
    K3 must have launched once a train step, K1 and K2 once an evaluator batch (K1 never for a model that reads
    deltas, ``k1`` False; K2 never for a model without res8's stem, ``k2`` False)."""
    import torch

    from howl_tpu_torch.training.run import train

    stats = train.LoopStats()
    _zero_launch_counts()
    results = train.run(argv, stats)
    torch.cuda.synchronize()
    counts = _launch_counts()
    print(f"{what}: {stats.steps} train steps, {stats.eval_batches} evaluator batches; launches K1 {counts['k1']} "
          f"(tc {counts['k1_tc']}), K2 {counts['k2']} (tc {counts['k2_tc']}), K3 {counts['k3']}")
    if counts["k3"] != stats.steps:
        raise AssertionError(f"{what}: K3 launched {counts['k3']} times in {stats.steps} augmented steps with a bank")
    if (counts["k1"], counts["k2"]) != (int(k1) * stats.eval_batches, int(k2) * stats.eval_batches):
        raise AssertionError(f"{what}: K1 {counts['k1']} and K2 {counts['k2']} launches for {stats.eval_batches} evaluator "
                             f"batches ({int(k1)} and {int(k2)} a batch expected)")
    return results, counts, stats


def _loop_idle_share(prof, steps: int, loop_s: float) -> str:
    """The device's busy time inside the profiled run's ``train_epoch`` ranges (the union of its kernels' and
    copies' intervals; the ranges' own device-side annotations left out), a step, against the profiled
    ranges' wall time and the unprofiled loop's wall time ``loop_s`` a step."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == "train_epoch" and e.device_type != cuda]
    work = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False) and e.name != "train_epoch"
        and any(a <= e.time_range.start < b for a, b in spans)
    )
    busy_us, end = 0.0, float("-inf")
    for a, b in work:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not spans or not work:
        return "device busy a step: not measured (the profiler saw no device time in the loop)"
    busy_ms, span_ms, wall_ms = busy_us / 1000 / steps, sum(b - a for a, b in spans) / 1000 / steps, loop_s * 1000
    return (f"{len(work) / steps:.1f} device operations a step, busy {busy_ms:.3f} ms a step; the profiled loop "
            f"{span_ms:.3f} ms a step (idle share {1 - busy_ms / span_ms:.3f}), the unprofiled loop {wall_ms:.3f} ms "
            f"a step (idle share {1 - busy_ms / wall_ms:.3f})")


ENTRY_RECIPE = {"WEIGHT_DECAY": "0.00001", "NUM_EPOCHS": str(ENTRY_EPOCHS), "LEARNING_RATE": "0.01",
                "LR_DECAY": "0.955", "BATCH_SIZE": "16", "MAX_WINDOW_SIZE_SECONDS": "0.5", "USE_NOISE_DATASET": "True",
                "NUM_MELS": str(N_MELS), "INFERENCE_SEQUENCE": "[0,1,2]", "VOCAB": '["hey","fire","fox"]',
                # the entry point splits the noise corpus by a hash of each clip's absolute path, as howl does: the
                # corpus is named by a path that is the same in every process, wherever the working directory lies
                # (``/proc/self/cwd``, the link to it), so that the split, and the training with it, repeats
                "NOISE_DATASET_PATH": "/proc/self/cwd/noise"}


@contextlib.contextmanager
def _restored_env(*names):
    """The environment variables ``names`` as they were, after the block."""
    import os

    saved = {k: os.environ.get(k) for k in names}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def entry_workdir():
    """A temporary working directory that holds phase 17's corpora (``ww``: the tone corpus, ``noise``), with
    ``ENTRY_RECIPE`` in the environment; yields its path. The caller's directory and environment are restored."""
    import os
    import tempfile
    from pathlib import Path

    from howl_tpu_torch.settings import SETTINGS

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="howl_train_entry_") as tmp_dir, _restored_env(*ENTRY_RECIPE):
        os.chdir(tmp_dir)
        try:
            write_tone_corpus(Path("ww"), ENTRY_CORPUS, ENTRY_CORPUS)
            write_noise_dir(Path("noise"))
            os.environ.update(ENTRY_RECIPE)
            SETTINGS.reset()
            yield Path(tmp_dir)
        finally:
            os.chdir(cwd)
            SETTINGS.reset()


def train_repeat_main() -> int:
    """``python3 chip_smoke.py --train-repeat``: one short run of phase 17's training (one epoch of
    ``ENTRY_STEPS`` steps from its seed) in a working directory of its own; its last line is
    {"dir": the directory, "epoch_losses": [...]}."""
    import os

    import torch

    from howl_tpu_torch.settings import SETTINGS

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py --train-repeat needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with entry_workdir() as tmp:
        os.environ["NUM_EPOCHS"] = "1"
        SETTINGS.reset()
        _, _, stats = _train_entry(["--model", "res8", "--workspace", "ws", "-i", "ww", "--device", "cuda",
                                    "--eval-freq", "0", "--steps-per-epoch", str(ENTRY_STEPS)], "repeat run")
        print(json.dumps({"dir": str(tmp), "epoch_losses": stats.epoch_losses}))
    return 0


def check_training_repeats() -> list:
    """F15: two processes each run :func:`train_repeat_main` at once, each in a temporary directory of its own;
    their epoch losses must be equal. Returns them."""
    from pathlib import Path

    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--train-repeat"],
                              cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    runs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"F15: a repeat run failed ({proc.returncode}):\n{out[-4000:]}\n{err[-4000:]}")
            runs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:  # a run left behind by a failure or a timeout
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    losses = [run["epoch_losses"] for run in runs]
    print(f"F15: two processes, each training 1 epoch of {ENTRY_STEPS} steps from one seed in a directory of its "
          f"own ({runs[0]['dir']}, {runs[1]['dir']}): epoch losses {[repr(x) for x in losses[0]]} and "
          f"{[repr(x) for x in losses[1]]}: {'equal' if losses[0] == losses[1] else 'DIFFERENT'}")
    if losses[0] != losses[1] or not losses[0] or runs[0]["dir"] == runs[1]["dir"]:
        raise AssertionError(f"F15: the entry point's training does not repeat from its seed: {runs}")
    return losses[0]


def drive_train_entry(dev) -> dict:
    """The training entry point, ``python -m howl_tpu_torch.training.run.train``, on the card at res8's full
    width: ``envs/res8.env``'s recipe with the noise corpus on, augmentation on, on a synthetic-tone corpus
    written here. First :func:`check_training_repeats`; then the full run, ``--eval`` on the same workspace, a
    short ``--resume``, a short ``--bf16 --fused-trunk`` run, and F9 on the trained weights."""
    import os
    from pathlib import Path

    import torch

    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.inference.config import EngineConfig
    from howl_tpu_torch.inference.engine import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route
    from howl_tpu_torch.settings import SETTINGS

    print(bench.card_line())
    repeat_losses = check_training_repeats()
    with entry_workdir():
        tmp, corpus = Path("."), Path("ww")
        ws = tmp / "ws"
        base = ["--model", "res8", "--workspace", str(ws), "-i", str(corpus), "--device", "cuda"]
        # the evaluators run K1 at the exact grade: on "tc" where frontend_route says so; K2 "tc" in bf16 only
        k1_tc = int(frontend_route(FrontendConfig.from_settings(), "f32") == "tc")
        results, counts, stats = _train_entry(base + ["--eval-freq", "0", "--steps-per-epoch", str(ENTRY_STEPS)], "train")
        if counts["k1_tc"] != k1_tc * stats.eval_batches or counts["k2_tc"]:
            raise AssertionError(f"the float32 evaluator: K1 'f32' on {'tc' if k1_tc else 'fma'} and K2 'fma' "
                                 f"expected: {counts}")
        loop_s = stats.prep_s + stats.step_s
        rates = {
            "steps_per_s": stats.steps / loop_s, "examples_per_s": stats.examples / loop_s,
            "prep_share": stats.prep_s / loop_s, "step_share": stats.step_s / loop_s,
            "eval_realtime_factor": stats.eval_audio_ms / 1000 / stats.eval_s,
        }
        print(f"train loop at batch 16: {rates['steps_per_s']:.1f} steps/s, {rates['examples_per_s']:.1f} examples/s "
              f"over {stats.steps} steps ({loop_s:.3f} s); host batch preparation {stats.prep_s:.3f} s "
              f"({rates['prep_share']:.3f}), train step {stats.step_s:.3f} s ({rates['step_share']:.3f}); "
              f"evaluator: {stats.eval_audio_ms / 1000:.1f} s of audio in {stats.eval_s:.3f} s, realtime factor "
              f"{rates['eval_realtime_factor']:.1f}")
        print(f"train: epoch losses {stats.epoch_losses[0]!r} (epoch 0; the repeat runs' {repeat_losses[0]!r}) ... "
              f"{stats.epoch_losses[-1]!r} (epoch {len(stats.epoch_losses) - 1})")
        print("final sweeps: " + ", ".join(f"{k} tp {v['tp']} fp {v['fp']} tn {v['tn']} fn {v['fn']}" for k, v in results.items()))
        missing = {"dev_noisy_pos", "dev_noisy_neg", "test_noisy_pos", "test_noisy_neg"} - set(results)
        if missing:
            raise AssertionError(f"the noisy sweeps {sorted(missing)} are missing")
        for key in ("dev_pos", "test_pos"):
            if results[key]["fn"] or not results[key]["tp"]:
                raise AssertionError(f"{key}: a positive was not detected: {results[key]}")
        for key in ("dev_neg", "test_neg"):
            if results[key]["fp"] or not results[key]["tn"]:
                raise AssertionError(f"{key}: a negative fired: {results[key]}")

        eval_results, _, _ = _train_entry(base + ["--eval"], "--eval from model-best.pt")
        if eval_results != results:
            raise AssertionError(f"--eval disagrees with the run's final sweeps: {eval_results} against {results}")
        if len((ws / "0.0_results.csv").read_text().splitlines()) != 8:
            raise AssertionError("--eval wrote no 8 rows of 0.0_results.csv")

        before = torch.load(ws / "train_state.pt", weights_only=True)
        os.environ["NUM_EPOCHS"] = str(ENTRY_RESUME_EPOCHS)
        SETTINGS.reset()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, _, resume_stats = _train_entry(
                base + ["--resume", "--eval-freq", "0", "--steps-per-epoch", str(ENTRY_STEPS)], "--resume")
        after = torch.load(ws / "train_state.pt", weights_only=True)
        want = before["step"] + resume_stats.steps
        adam_steps = {float(s["step"]) for s in after["optimizer"]["state"].values()}
        print(f"--resume: step {before['step']} -> {after['step']}; AdamW's step counts {sorted(adam_steps)}")
        if after["step"] != want or adam_steps != {float(want)}:
            raise AssertionError(f"--resume did not continue the step count and the AdamW state from step {before['step']}")
        idle = _loop_idle_share(prof, resume_stats.steps, loop_s / stats.steps)
        print(f"train loop, batch 16: {idle}")

        _, counts, bf16_stats = _train_entry(
            ["--model", "res8", "--workspace", str(tmp / "ws_bf16"), "-i", str(corpus), "--device", "cuda",
             "--bf16", "--fused-trunk", "--eval-freq", "1", "--steps-per-epoch", "5"], "--bf16 --fused-trunk")
        if counts["k2_tc"] != bf16_stats.eval_batches or counts["k1_tc"] != k1_tc * bf16_stats.eval_batches:
            raise AssertionError(f"the bf16 evaluator: K2 'tc' once a batch and K1 at the exact grade on "
                                 f"{'tc' if k1_tc else 'fma'} expected: {counts}")

        # F9: the bf16 engine as served (K1 "tc" at the "bf16" grade, K2 "tc") against the float32 engine at
        # the exact grade, on every dev and test clip, on the weights this run trained
        ctx = InferenceContext(vocab=SETTINGS.training.vocab)
        zmuv = json.loads((ws / "zmuv.json").read_text())
        mean, std = zmuv["mean"], float(np.sqrt(zmuv["mean2"] - zmuv["mean"] ** 2))
        state_dict = torch.load(ws / "model.pt", weights_only=True)
        engines = {name: StreamingEngine(create_model("res8", num_labels=ctx.num_labels), state_dict,
                                         EngineConfig.from_settings(ctx), FrontendConfig.from_settings(), mean, std,
                                         compute_dtype=dtype, frontend_precision=grade, device=dev)
                   for name, dtype, grade in (("f32", None, "f32"), ("bf16", torch.bfloat16, "bf16"))}
        ww_train, ww_dev, ww_test = WakeWordDatasetLoader().load_splits(corpus, sample_rate=SAMPLE_RATE, mono=True)
        audio = np.stack([ds[i].audio_data for ds in (ww_dev, ww_test) for i in range(len(ds))])
        out = {name: eng.infer_batch(audio) for name, eng in engines.items()}
        dprob = float((out["bf16"]["probs"] - out["f32"]["probs"]).abs().max())
        fired = out["f32"]["detected"].tolist()
        print(f"F9 on the trained weights, {len(audio)} dev and test clips ({sum(fired)} fire): bf16 decisions "
              f"{'equal' if fired == out['bf16']['detected'].tolist() else 'DIFFER FROM'} float32's; max |dprob| {dprob:.3e}")
        if fired != out["bf16"]["detected"].tolist():
            raise AssertionError("F9: the bf16 engine's decisions differ from the float32 engine's on the trained weights")

        # the int8 headline on the trained weights: bf16, K1 "tc", K2 "tc", the int8 trunk calibrated on the train
        # clips, its trunk one launch of the fused kernel. On the same weights and calibration its posteriors must
        # be the plain int8 trunk's bit for bit and its decisions the same, whatever the card's training produced;
        # its detections must equal the float32 engine's at the exact grade, as F9's. Its first fires against the
        # float32 engine are printed, not gated (ROADMAP F14): the shift measures the weights this run trained
        # (2 and 4 hops in two runs of five while the training did not repeat, F15); the CPU tests hold the int8
        # scheme's own shift on fixed weights (tests/test_torch_int8_trunk.py).
        from howl_tpu_torch.ops.int8_trunk import (
            int8_conv_layer_cuda, int8_trunk_fused_cuda, residual_features_int8_plain,
        )

        cal = np.stack([ww_train[i].audio_data for i in range(len(ww_train))])
        int8_eng = StreamingEngine(create_model("res8", num_labels=ctx.num_labels), state_dict,
                                   EngineConfig.from_settings(ctx), FrontendConfig.from_settings(), mean, std,
                                   compute_dtype=torch.bfloat16, frontend_precision="bf16", use_int8_trunk=True,
                                   int8_calibration_audio=cal, device=dev)
        int8_trunk_fused_cuda.launches = int8_conv_layer_cuda.launches = 0
        got = int8_eng.infer_batch(audio)
        torch.cuda.synchronize()
        if (int8_trunk_fused_cuda.launches, int8_conv_layer_cuda.launches) != (1, 0):
            raise AssertionError(f"the int8 engine's trunk ran {int8_trunk_fused_cuda.launches} fused and "
                                 f"{int8_conv_layer_cuda.launches} layer launches, not one fused launch")
        with torch.no_grad():
            clips = int8_eng._as_audio(audio)
            geom = int8_eng._step_geometry(*clips.shape)
            trunk = residual_features_int8_plain(int8_eng._pooled_stem(clips), int8_eng._int8_params, torch.bfloat16)
            plain = int8_eng._decide(int8_eng._window_posteriors(trunk, geom["n_win"]),
                                     int8_eng._as_lengths(None, *clips.shape), geom)
        probs_eq = torch.equal(got["probs"], plain["probs"])
        plain_eq = {key: torch.equal(got[key].cpu(), plain[key].cpu()) for key in ("detected", "first_fire_step", "labels")}
        detected_eq = torch.equal(got["detected"].cpu(), out["f32"]["detected"].cpu())
        shift = (got["first_fire_step"].cpu() - out["f32"]["first_fire_step"].cpu()).abs()
        labels = float((got["labels"].cpu() == out["f32"]["labels"].cpu()).double().mean())
        int8_dprob = float((got["probs"] - out["f32"]["probs"]).abs().max())
        print(f"int8 engine on the trained weights, calibrated on {len(cal)} train clips: against the plain int8 "
              f"trunk on the same weights, posteriors bit for bit {probs_eq}, decisions equal "
              f"{all(plain_eq.values())} ({', '.join(k for k, v in plain_eq.items() if not v) or 'all keys'}); "
              f"against the float32 engine, detections equal {detected_eq}; first fires equal on "
              f"{int((shift == 0).sum())} of {len(shift)} clips, at most {int(shift.max())} hop(s) apart (printed, "
              f"not gated); labels agree {labels:.4f}; max |dprob| {int8_dprob:.3e}")
        if not (probs_eq and all(plain_eq.values())):
            raise AssertionError("the int8 engine's fused trunk disagrees with the plain int8 trunk on the trained weights")
        if not detected_eq:
            raise AssertionError("the int8 engine's detections differ from the float32 engine's on the trained weights")
        return {**rates, "steps": stats.steps, "eval_batches": stats.eval_batches, "f9_max_dprob": dprob,
                "int8_max_dprob": int8_dprob, "repeat_losses": repeat_losses, "epoch_losses": stats.epoch_losses,
                "state_dict": state_dict, "zmuv": zmuv}


def _serving_workspaces(root, state_dict, zmuv: dict):
    """(port workspace, reference-layout workspace) of the weights ``state_dict`` and ZMUV stats ``zmuv``, with
    ``SETTINGS`` (phase 17's recipe) as their settings: ``model-best.pt``, ``zmuv.json``, ``settings.json`` and
    ``cmd-args.json``; and castorini/howl's ``model-best.pt.bin``, ``zmuv.pt.bin`` and underscore-keyed
    ``settings.json`` with its torch device string."""
    import torch

    from howl_tpu_torch.ops.zmuv import ZmuvTransform
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.workspace import Workspace

    port = Workspace(root / "ws_port", delete_existing=False)
    port.save_settings(SETTINGS)
    port.save_zmuv(ZmuvTransform.from_state_dict(zmuv))
    port.save_model(state_dict, best=True)
    ref = root / "ws_reference"
    ref.mkdir()
    data = {f"_{k}": v for k, v in SETTINGS.to_dict().items() if k not in ("dataset", "resource")}
    data["_training"]["device"] = "cuda:0"
    (ref / "settings.json").write_text(json.dumps(data))
    torch.save({k: torch.tensor([float(zmuv[k])]) for k in ("total", "mean", "mean2")}, ref / "zmuv.pt.bin")
    torch.save(state_dict, ref / "model-best.pt.bin")
    for path in (port.path, ref):
        (path / "cmd-args.json").write_text(json.dumps({"model": "res8"}))
    return port.path, ref


def _feed_live(engine, audio) -> np.ndarray:
    """Drive a live engine over (N, samples) device audio as ``HowlClient`` drives it: each hop's samples to an
    engine with ``push`` (``hop_block`` hops a call to a blocked one), the window ending at each hop, once the
    first is whole, to the ``OnlineEngine``. Returns the (hops, N) fire flags."""
    hop = engine.hop_samples
    fired = []
    if hasattr(engine, "push"):
        width = hop * getattr(engine, "hop_block", 1)
        for end in range(width, audio.shape[1] + 1, width):
            engine.push(audio[:, end - width : end])
            fired += list(engine.last_fired.T) if engine.last_fired.ndim == 2 else [engine.last_fired]
    else:
        for end in range(engine.window_samples, audio.shape[1] + 1, hop):
            engine.ingest(audio[:, end - engine.window_samples : end])
            fired.append(engine.last_fired)
    return np.stack(fired)


def drive_serving_surface(dev, state_dict, zmuv: dict) -> dict:
    """Phase 17c, the live serving surface (``howl_tpu_torch.hub``, ``client``, ``native``) on phase 17's trained
    res8: (a) a port workspace and a reference-layout one, each served by ``hub.load_workspace_engine`` as every
    engine kind on the dev and test clips (one stream each, ``SERVE_PAD_S`` of silence after each), each stream's
    detection equal to the offline engine's (``hub.load_workspace_streaming_engine``) on its clip, K1's and K2's
    launches equal to the directly built engines' on the same hops, and ``HowlClient`` over WAVs of four clips as
    the offline engine decides them; (b) ``MultiStreamServer`` at ``SERVE_STREAMS`` streams on the native mux for
    ``SERVE_TICKS`` ticks; (c) ``bench_stream_mux``; (d) the four live tools at ``LIVE_TOOL_STREAMS`` streams;
    (e) ``gen_capacity_table --calibrate`` at ``SERVE_CALIBRATION``, ``SERVE_CALIBRATION_STEPS`` steps a point."""
    from pathlib import Path

    import torch

    from howl_tpu_torch import hub, inference, native
    from howl_tpu_torch.client import FileAudioSource, HowlClient
    from howl_tpu_torch.client.stream_server import MultiStreamServer
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.inference.config import EngineConfig
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.zmuv import ZmuvTransform
    from howl_tpu_torch.tools import (
        ablate_trunk_step, bench_online_dft_precision, bench_stream_mux, bench_streaming_trunk, bench_trunk_blocked,
        gen_capacity_table,
    )
    from howl_tpu_torch.utils.audio_utils import write_wav

    print(bench.card_line())
    if not native.available():
        raise AssertionError("the native serving runtime did not build (g++ and native/howl_native.cpp)")
    out = {"launches": {}, "seconds": {}}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        out["seconds"][name] = time.perf_counter() - t_part
        t_part = time.perf_counter()
    with entry_workdir() as tmp:
        tmp = Path(tmp)
        port_ws, ref_ws = _serving_workspaces(tmp, state_dict, zmuv)
        _, ww_dev, ww_test = WakeWordDatasetLoader().load_splits(Path("ww"), sample_rate=SAMPLE_RATE, mono=True)
        clips = np.stack([ds[i].audio_data for ds in (ww_dev, ww_test) for i in range(len(ds))])
        n = len(clips)
        _zero_launch_counts()
        offline, ctx = hub.load_workspace_streaming_engine(port_ws, device=dev)
        want = offline.infer_batch(clips)["detected"].cpu().numpy()
        torch.cuda.synchronize()
        out["launches"]["offline"] = _launch_counts()
        if (out["launches"]["offline"]["k1"], out["launches"]["offline"]["k2"]) != (1, 1):
            raise AssertionError(f"the hub's offline engine: one K1 and one K2 launch a batch expected: "
                                 f"{out['launches']['offline']}")
        if want.all() or not want.any():
            raise AssertionError(f"the trained weights decide every clip one way offline: {want.tolist()}")
        pad = int(SERVE_PAD_S * SAMPLE_RATE)
        audio = torch.from_numpy(np.pad(clips, ((0, 0), (0, pad))).astype(np.float32)).to(dev)
        kinds = {"online": {}, "incremental": {"incremental": True}, "trunk": {"streaming_trunk": True},
                 "blocked": {"streaming_trunk": True, "hop_block": 3}, "auto": {"auto": True}}
        direct_cls = {"online": inference.OnlineEngine, "incremental": inference.IncrementalOnlineEngine,
                      "trunk": inference.FusedStreamingOnlineEngine}
        for layout, ws in (("port", port_ws), ("reference", ref_ws)):
            for kind, flags in kinds.items():
                _zero_launch_counts()
                eng, _ = hub.load_workspace_engine(ws, num_streams=n, device=dev, **flags)
                t0 = time.perf_counter()
                fired = _feed_live(eng, audio)
                hop_ms = (time.perf_counter() - t0) * 1e3 / len(fired)
                torch.cuda.synchronize()
                counts = _launch_counts()
                got = fired.any(0)
                tag = f"{layout} {kind} ({type(eng).__name__}, hop_block {getattr(eng, 'hop_block', 1)})"
                print(f"hub {tag}: {len(fired)} hops of {n} streams, {hop_ms:.2f} ms a hop; K1 {counts['k1']} (tc "
                      f"{counts['k1_tc']}), K2 {counts['k2']} (tc {counts['k2_tc']}); detections "
                      f"{'equal' if got.tolist() == want.tolist() else 'DIFFER FROM'} the offline engine's "
                      f"({int(got.sum())} of {n})", flush=True)
                if got.tolist() != want.tolist():
                    raise AssertionError(f"hub {tag}: detections {got.tolist()} against offline {want.tolist()}")
                out["launches"][f"{layout} {kind}"] = counts
                if layout == "port" and kind in direct_cls:
                    _zero_launch_counts()
                    extra = {"carry_hops": False} if kind != "trunk" else {}
                    stats = ZmuvTransform.from_state_dict(zmuv)
                    direct = direct_cls[kind](create_model("res8", num_labels=ctx.num_labels), state_dict,
                                              EngineConfig.from_settings(ctx), FrontendConfig.from_settings(),
                                              stats.mean, stats.std, num_streams=n, device=dev, **extra)
                    direct_fired = _feed_live(direct, audio)
                    torch.cuda.synchronize()
                    direct_counts = _launch_counts()
                    hops = len(fired)
                    expect = {"online": (hops, hops), "incremental": (0, hops), "trunk": (0, 1)}[kind]
                    print(f"  direct {type(direct).__name__}: K1 {direct_counts['k1']}, K2 {direct_counts['k2']}; fire "
                          f"flags {'equal' if np.array_equal(direct_fired, fired) else 'DIFFER'}", flush=True)
                    if direct_counts != counts or (counts["k1"], counts["k2"]) != expect:
                        raise AssertionError(f"hub {tag}: launches {counts}, the direct engine's {direct_counts}, "
                                             f"(K1, K2) {expect} expected")
                    if not np.array_equal(direct_fired, fired):
                        raise AssertionError(f"hub {tag}: fire flags differ from the directly built engine's")
                del eng
        silence = tmp / "silence.wav"
        write_wav(silence, np.zeros(pad, np.float32), SAMPLE_RATE)
        wavs = sorted(Path("ww/audio").glob("pos_*.wav"))[:2] + sorted(Path("ww/audio").glob("neg_*.wav"))[:2]
        from howl_tpu_torch.utils.audio_utils import silent_load

        wav_want = offline.infer_batch(np.stack([silent_load(w) for w in wavs]))["detected"].cpu().tolist()
        for kind in ("online", "incremental", "trunk"):
            got = []
            for wav in wavs:
                client = HowlClient.from_workspace(port_ws, source=FileAudioSource([wav, silence]), device=dev,
                                                   **kinds[kind])
                client.start().join()
                got.append(client.detections > 0)
            print(f"HowlClient ({kind}) over {len(wavs)} WAVs: detections {got}, the offline engine's {wav_want}",
                  flush=True)
            if got != wav_want:
                raise AssertionError(f"HowlClient ({kind}): detections {got} against the offline engine's {wav_want}")
        part("(a) hub and client")

        # (b) many streams through one batched engine, fed by the native mux
        eng, _ = hub.load_workspace_engine(port_ws, num_streams=SERVE_STREAMS, incremental=True, device=dev)
        server = MultiStreamServer(eng)
        buf = (np.random.default_rng(SEED).standard_normal((SERVE_STREAMS, (SERVE_TICKS + 1) * eng.hop_samples))
               * 0.1).astype(np.float32)
        ticks_ms = []
        for t in range(SERVE_TICKS + 1):
            for s in range(SERVE_STREAMS):
                server.push(s, buf[s, t * eng.hop_samples : (t + 1) * eng.hop_samples])
            t0 = time.perf_counter()
            result = server.tick()
            ticks_ms.append((time.perf_counter() - t0) * 1e3)
            if (result.status != 1).any() or result.fired.shape != (SERVE_STREAMS,):
                raise AssertionError(f"tick {t}: statuses {np.unique(result.status).tolist()}, fired "
                                     f"{result.fired.shape}")
        ticks_ms = ticks_ms[1:]  # the first tick is the warm-up
        out["server"] = {"native": native.available(), "streams": SERVE_STREAMS, "ticks": len(ticks_ms),
                         "mean_ms": float(np.mean(ticks_ms)), "p99_ms": float(np.percentile(ticks_ms, 99)),
                         "underruns": int(server.underruns.sum()), "overruns": int(server.overruns.sum()),
                         "alarms": server.alarms, "late_ticks": server.late_ticks}
        print(f"MultiStreamServer, {SERVE_STREAMS} streams on the native mux (available() {native.available()}), "
              f"IncrementalOnlineEngine in float32: {len(ticks_ms)} ticks, mean {out['server']['mean_ms']:.3f} ms, "
              f"p99 {out['server']['p99_ms']:.3f} ms a tick; underruns {out['server']['underruns']}, overruns "
              f"{out['server']['overruns']}, late ticks {server.late_ticks}, alarms {server.alarms}", flush=True)
        if server.underruns.sum() or server.overruns.sum():
            raise AssertionError("the server under- or overran with every stream's audio pushed before each tick")
        del eng, server, offline
        torch.cuda.empty_cache()
        part("(b) server")

    # (c) the mux alone, (d) the live tools, (e) the capacity calibration
    out["mux"] = bench_stream_mux.main(["--device", "cuda"])
    if not out["mux"]["native"]:
        raise AssertionError("bench_stream_mux ran the numpy fallback")
    part("(c) mux")
    streams = str(LIVE_TOOL_STREAMS)
    out["trunk_vs_incremental"] = bench_streaming_trunk.main(["--device", "cuda", streams, "12"])
    torch.cuda.empty_cache()
    out["blocked"] = bench_trunk_blocked.main(["--device", "cuda", streams, "4"])
    torch.cuda.empty_cache()
    out["ablation"] = ablate_trunk_step.main(["--device", "cuda", streams, "4"])
    torch.cuda.empty_cache()
    out["dft"] = bench_online_dft_precision.main(["--device", "cuda", "--counts", streams,
                                                  "--samples", str(DFT_SAMPLES)])
    torch.cuda.empty_cache()
    times = [out["trunk_vs_incremental"]["trunk_ms"], out["trunk_vs_incremental"]["incremental_ms"],
             out["blocked"]["per_hop"], *out["blocked"]["blocked"].values(),
             *(out["ablation"][leg] for leg in ablate_trunk_step.LEGS),
             *(r[q] for r in out["dft"].values() for q in ("p50", "p99"))]
    if not all(np.isfinite(times)) or min(times) <= 0:
        raise AssertionError(f"a live tool printed a time that is not finite and positive: {times}")
    part("(d) live tools")
    cal_counts = ",".join(map(str, SERVE_CALIBRATION))
    out["calibration"] = gen_capacity_table.main(["--device", "cuda", "--calibrate", cal_counts,
                                                  "--steps", str(SERVE_CALIBRATION_STEPS)])
    part("(e) calibration")
    print("serving surface seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def drive_config_and_harness(dev) -> dict:
    """(17d) On phase 17's tone corpus and noise corpus (``entry_workdir``), res8 in float32: (a) a
    ``TrainingConfig`` of phase 17's recipe, written with ``Workspace.save_config`` and read back equal with
    ``load_config``, trained by ``Trainer.train`` with ``--use-timestretch`` for ``CONFIG_EPOCHS`` epochs of
    ``ENTRY_STEPS`` steps: K3 once a step, K1 and K2 once an evaluator batch, ``model-best.pt`` and
    ``training_config.json`` written, the results holding ``test_pos``; (b) the experiment harness,
    ``eval_wake_word_detection.run -n 2 --sharded-seeds``, ``HARNESS_EPOCHS`` epochs of ``ENTRY_STEPS`` sweep
    steps: K3 once a sweep step (not once a seed), K1 and K2 once an evaluator batch of the two seeds' threshold
    sweeps, the seeds' weights different, ``reports/report_clean.csv`` with a row for every set, threshold and
    metric and tp + fn the positive set's size at every threshold, ``generate_roc.load_metrics`` reading it; each
    seed's first-step loss equal to its own single-model step's at its key within ``SWEEP_LOSS_RTOL``; then the
    sweep's steps/s against two single-seed runs on the same ``ENTRY_STEPS`` batches, after a warm-up pass of each,
    in turns (sweep, singles, singles, sweep). Prints the phase's seconds and the card's name and power limit.
    Returns the launch counts and rates."""
    import argparse
    import os
    from pathlib import Path

    import torch

    from howl_tpu_torch.config import ContextConfig, DatasetConfig, ModelConfig, TrainingConfig
    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.ops.tf32 import exact_float32
    from howl_tpu_torch.parallel import make_seed_sweep_step
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.trainer import Trainer
    from howl_tpu_torch.training.run import eval_wake_word_detection as harness
    from howl_tpu_torch.training.run import train
    from howl_tpu_torch.training.run.generate_roc import load_metrics
    from howl_tpu_torch.workspace import Workspace

    print(bench.card_line())
    t_phase = time.perf_counter()
    out = {}
    with entry_workdir():
        # (a) the Trainer from a TrainingConfig, phase 17's recipe
        cfg = TrainingConfig(
            batch_size=16, learning_rate=0.01, num_epochs=CONFIG_EPOCHS, lr_decay=0.955, weight_decay=0.00001,
            max_window_size_seconds=0.5, use_noise_dataset=True,
            noise_datasets=[DatasetConfig(path=ENTRY_RECIPE["NOISE_DATASET_PATH"])],
            train_datasets=[DatasetConfig(path="ww")],
            context_config=ContextConfig(vocab=["hey", "fire", "fox"], sequence=[0, 1, 2]),
            model_config=ModelConfig(architecture="res8"),
        )
        cfg.train_datasets[0].audio_transform_config.num_mels = N_MELS
        Workspace(Path("cfg_ws")).save_config(cfg)
        loaded = Workspace(Path("cfg_ws"), delete_existing=False).load_config()
        if loaded != cfg or cfg.workspace_path != "cfg_ws":
            raise AssertionError(f"save_config / load_config: {loaded} != {cfg}")
        stats = train.LoopStats()
        _zero_launch_counts()
        results = Trainer(loaded).train(["--device", "cuda", "--use-timestretch", "--steps-per-epoch", str(ENTRY_STEPS)],
                                        stats)
        torch.cuda.synchronize()
        counts = _launch_counts()
        loop_s = stats.prep_s + stats.step_s
        print(f"17d (a) Trainer from a TrainingConfig, --use-timestretch: {stats.steps} steps, {stats.steps / loop_s:.1f} "
              f"steps/s (host batch preparation with the stretch {stats.prep_s:.3f} s, train step {stats.step_s:.3f} s), "
              f"epoch losses {stats.epoch_losses[0]!r} -> {stats.epoch_losses[-1]!r}; {stats.eval_batches} evaluator "
              f"batches; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']}; test positives fired "
              f"{results['test_pos']['tp']} of {results['test_pos']['tp'] + results['test_pos']['fn']}")
        if counts["k3"] != stats.steps or stats.steps != CONFIG_EPOCHS * ENTRY_STEPS:
            raise AssertionError(f"17d (a): K3 launched {counts['k3']} times in {stats.steps} steps")
        if (counts["k1"], counts["k2"]) != (stats.eval_batches, stats.eval_batches):
            raise AssertionError(f"17d (a): K1 {counts['k1']}, K2 {counts['k2']} for {stats.eval_batches} evaluator batches")
        for name in ("model-best.pt", "training_config.json"):
            if not Path("cfg_ws", name).exists():
                raise AssertionError(f"17d (a): the Trainer wrote no {name}")
        if "test_pos" not in results or not np.isfinite(stats.epoch_losses).all():
            raise AssertionError(f"17d (a): results {sorted(results)}, losses {stats.epoch_losses}")
        out["k3_trainer"], out["k1_trainer"] = counts["k3"], counts["k1"]

        # (b) the harness: two seeds in one sweep, then every seed's threshold sweep and the reports
        os.environ["NUM_EPOCHS"] = str(HARNESS_EPOCHS)
        SETTINGS.reset()
        argv = ["--workspace", "exp", "-i", "ww", "-n", str(HARNESS_SEEDS), "--sharded-seeds", "--steps-per-epoch",
                str(ENTRY_STEPS), "--device", "cuda"]
        stats = train.LoopStats()
        _zero_launch_counts()
        t0 = time.perf_counter()
        record = harness.run(argv, stats)
        torch.cuda.synchronize()
        harness_s = time.perf_counter() - t0
        counts = _launch_counts()
        sweep = record["train"]
        print(f"17d (b) harness -n {HARNESS_SEEDS} --sharded-seeds: {sweep['steps']} sweep steps "
              f"({sweep['steps'] / sweep['step_s']:.1f} sweep steps/s in the harness's loop), {stats.eval_batches} "
              f"evaluator batches, {len(record['thresholds'])} thresholds, {harness_s:.1f} s; launches K1 {counts['k1']}, "
              f"K2 {counts['k2']}, K3 {counts['k3']}; per-seed epoch losses {sweep['epoch_losses']}")
        if counts["k3"] != sweep["steps"] or sweep["steps"] != HARNESS_EPOCHS * ENTRY_STEPS:
            raise AssertionError(f"17d (b): K3 launched {counts['k3']} times in {sweep['steps']} sweep steps of "
                                 f"{HARNESS_SEEDS} seeds (once a sweep step expected)")
        if (counts["k1"], counts["k2"]) != (stats.eval_batches, stats.eval_batches) or not stats.eval_batches:
            raise AssertionError(f"17d (b): K1 {counts['k1']}, K2 {counts['k2']} for {stats.eval_batches} evaluator batches")
        weights = [torch.load(Path("exp", f"seed_{s}", "model-best.pt"), weights_only=True) for s in range(HARNESS_SEEDS)]
        if all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0]):
            raise AssertionError("17d (b): the two seeds' workspaces hold the same weights")
        ctx = InferenceContext(vocab=["hey", "fire", "fox"])
        _, dev_ds, test_ds = WakeWordDatasetLoader().load_splits(Path("ww"), sample_rate=SAMPLE_RATE, mono=True,
                                                                 frame_labeler=ctx.labeler)
        positives = {split: sum(bool(ctx.searcher.search(ds.metadata_list[i].transcription)) for i in range(len(ds)))
                     for split, ds in (("Dev", dev_ds), ("Test", test_ds))}
        rows = Path("exp", "reports", "report_clean.csv").read_text().splitlines()[1:]
        table = {(r.split(",")[0], float(r.split(",")[1]), r.split(",")[2]): float(r.split(",")[3]) for r in rows}
        sets = [f"{split} {kind}" for split in ("Dev", "Test") for kind in ("positive", "negative")]
        metrics = ("tp", "tn", "fp", "fn", "tp_rate", "fah")
        if set(table) != {(n, float(t), m) for n in sets for t in record["thresholds"] for m in metrics}:
            raise AssertionError("17d (b): report_clean.csv lacks a row of a set, threshold or metric")
        for split, size in positives.items():
            bad = [t for t in record["thresholds"]
                   if table[(f"{split} positive", float(t), "tp")] + table[(f"{split} positive", float(t), "fn")] != size]
            if bad or not size:
                raise AssertionError(f"17d (b): {split} positives: tp + fn != {size} at thresholds {bad}")
        points = load_metrics(Path("exp", "reports", "report_clean.csv"), "Test")
        if len(points) != len(record["thresholds"]):
            raise AssertionError(f"17d (b): load_metrics read {len(points)} points for {len(record['thresholds'])} thresholds")
        print("17d (b) Test ROC (threshold, false alarms an hour, false rejection rate): "
              + ", ".join(f"({t}, {fah:.1f}, {frr:.2f})" for t, fah, frr in points[::4]))

        # each seed's first sweep step against its own single-model step, then the sweep's rate against single seeds
        SETTINGS.reset()
        args = argparse.Namespace(model="res8", dataset_paths=["ww"], use_stitched_datasets=False, use_augment=True,
                                  steps_per_epoch=ENTRY_STEPS)
        seeds = list(range(HARNESS_SEEDS))
        setup = harness.seed_training(args, seeds, dev)
        batches = setup.batches()
        batches = [next(batches) for _ in range(ENTRY_STEPS)]
        with exact_float32():
            first = []
            for s in seeds:
                state = setup.create_states([s])[0]
                _, m = setup.train_step(state, *(x[s] for x in batches[0]), s)
                first.append(float(m["loss"]))
            want = sweep["step_losses"][0].tolist()
            print(f"17d seed sweep: first-step losses {[repr(x) for x in want]}, each seed's single-model step at its key "
                  f"{[repr(x) for x in first]}")
            if any(abs(a - b) > SWEEP_LOSS_RTOL * abs(b) for a, b in zip(want, first)):
                raise AssertionError(f"17d: the sweep's first-step losses {want} are not the single steps' {first}")
            states, step = setup.create_states(), make_seed_sweep_step(setup.train_step)
            singles = [setup.create_states([s])[0] for s in seeds]

            def sweep_pass() -> float:
                t0 = time.perf_counter()
                for batch in batches:
                    _, m = step(states, *batch, seeds)
                    m["loss"].cpu()
                return time.perf_counter() - t0

            def singles_pass() -> float:
                t0 = time.perf_counter()
                for s, state in zip(seeds, singles):
                    for batch in batches:
                        _, m = setup.train_step(state, *(x[s] for x in batch), s)
                        float(m["loss"])
                return time.perf_counter() - t0

            sweep_pass(), singles_pass()  # a warm-up pass of each
            turns = [fn() for fn in (sweep_pass, singles_pass, singles_pass, sweep_pass)]
        out["sweep_steps_per_s"] = sorted(ENTRY_STEPS / t for t in turns[::3])
        out["singles_steps_per_s"] = sorted(ENTRY_STEPS / t for t in turns[1:3])
        print(f"17d seed sweep on the same {ENTRY_STEPS} batches on the device (host clock, each loss read back; a warm-up "
              f"pass of each, then in turns sweep, singles, singles, sweep: {', '.join(f'{t:.3f}' for t in turns)} s): "
              f"{HARNESS_SEEDS} seeds in one sweep {out['sweep_steps_per_s'][0]:.1f}-{out['sweep_steps_per_s'][1]:.1f} "
              f"sweep steps/s, {HARNESS_SEEDS} single-seed runs one after another "
              f"{out['singles_steps_per_s'][0]:.1f}-{out['singles_steps_per_s'][1]:.1f} steps/s of all seeds")
        out["k3_sweep"], out["k1_harness"], out["k2_harness"] = counts["k3"], counts["k1"], counts["k2"]
    print(f"17d config-driven Trainer and experiment harness: {time.perf_counter() - t_phase:.1f} s")
    return out


def write_cv_corpus(root, n: int, seconds: float = 1.5):
    """A Common Voice-layout tone corpus: ``clips/*.wav`` and ``train.tsv``, ``dev.tsv``, ``test.tsv`` with
    ``client_id``, ``path`` and ``sentence``. Clip i is a tone of 300 + 50 (i % 8) Hz with noise drawn from the seed
    i, said by client i % 5; it goes to train where i % 6 < 4, else to dev (4) or test (5), and says, by i // 6 % 4,
    "hey fire fox", "hey fire fox is here", "the fire is warm" (a word of the phrase, not the phrase) or "nothing to
    see here"."""
    from pathlib import Path

    from howl_tpu_torch.utils.audio_utils import write_wav

    root = Path(root)
    (root / "clips").mkdir(parents=True, exist_ok=True)
    sentences = ("hey fire fox", "hey fire fox is here", "the fire is warm", "nothing to see here")
    tsvs = ("train.tsv",) * 4 + ("dev.tsv", "test.tsv")
    rows = {name: ["client_id\tpath\tsentence"] for name in tsvs}
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    for i in range(n):
        noise = np.random.default_rng(i).standard_normal(t.shape)
        write_wav(root / "clips" / f"cv_{i:03d}.wav",
                  (0.3 * np.sin(2 * np.pi * (300 + 50 * (i % 8)) * t) + 0.02 * noise).astype(np.float32), SAMPLE_RATE)
        rows[tsvs[i % 6]].append(f"client{i % 5}\tcv_{i:03d}.wav\t{sentences[i // 6 % 4]}")
    for name, lines in rows.items():
        (root / name).write_text("\n".join(lines) + "\n")
    return root


def write_gsc_corpus(root, words=GSC_WORDS, n_per_word: int = GSC_CLIPS, seconds: float = 1.0):
    """A Speech Commands-layout tone corpus, as ``tests/fixtures.py``'s ``make_gsc_corpus`` writes it:
    ``<word>/<word>_<i>.wav``, ``testing_list.txt`` and ``validation_list.txt``; word k is a tone of 300 + 150 k Hz,
    jittered by 3 % a clip, with noise; clip i % 5 == 3 is dev, 4 test, the rest train."""
    from pathlib import Path

    from howl_tpu_torch.utils.audio_utils import write_wav

    root = Path(root)
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    lists = {3: [], 4: []}
    for k, word in enumerate(words):
        (root / word).mkdir(parents=True, exist_ok=True)
        for i in range(n_per_word):
            f = (300.0 + 150.0 * k) * (1.0 + 0.03 * rng.standard_normal())
            clip = 0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(t.shape)
            name = f"{word}/{word}_{i:03d}.wav"
            write_wav(root / name, clip.astype(np.float32), SAMPLE_RATE)
            if i % 5 in lists:
                lists[i % 5].append(name)
    (root / "validation_list.txt").write_text("\n".join(lists[3]) + "\n")
    (root / "testing_list.txt").write_text("\n".join(lists[4]) + "\n")
    return root


def _gsc_counts(what: str, stats, counts: dict) -> None:
    """GSC pretraining launches neither K1 (its features come from the plain chain) nor K3 (its step has no bank);
    K2, res8's stem kernel, once an eval batch."""
    print(f"{what}: {stats.steps} steps ({stats.steps / max(stats.prep_s + stats.step_s, 1e-9):.1f} steps/s: host batch "
          f"preparation {stats.prep_s:.3f} s, train step {stats.step_s:.3f} s), {stats.eval_batches} eval batches; "
          f"launches K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']}")
    if (counts["k1"], counts["k2"], counts["k3"]) != (0, stats.eval_batches, 0) or not stats.eval_batches:
        raise AssertionError(f"{what}: K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']} launches for "
                             f"{stats.eval_batches} eval batches (0, one an eval batch, 0 expected)")


def drive_gsc_and_dataset_pipeline(dev) -> dict:
    """(17e) In phase 17's working directory (``entry_workdir``: its noise corpus, its recipe): (a) the dataset
    pipeline of ``generate_dataset.sh`` on a Common Voice-layout tone corpus (``write_cv_corpus``):
    ``generate_raw_audio_dataset`` (positives and negatives), ``attach_alignment --alignment-type stub`` on both,
    ``stitch_vocab_samples --disable-detect-keyword`` after a seeded ``random``; every stitched clip says the phrase with
    all three word labels; then res8 trained on the positive set and its stitched set through the entry point
    (``--use-stitched-datasets``) in float32 with the noise corpus, ``STITCH_EPOCHS`` epochs of ``ENTRY_STEPS`` steps:
    K3 once a step, K1 and K2 once an evaluator batch. (b) GSC pretraining on a Speech Commands-layout tone corpus
    (``write_gsc_corpus``) at the protocol's widths: res8 at 45 maps, float32, ``GSC_EPOCHS`` epochs, 10 % silence (12
    labels); then ``--sharded-seeds 2 --bf16``, each seed's first sweep step's loss bit for bit its own single-model
    step's at its key on its batch; then ``eval_commands_recognition --models res8 -n 2``. GSC pretraining launches
    neither K1 nor K3, as in JAX, and K2 once an eval batch. Prints the stitched counts, steps/s, accuracies, launch
    counts and the phase's seconds. Returns the launch counts and rates."""
    import math
    import os
    import random
    from pathlib import Path

    import torch

    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.parallel import create_seed_states
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import (
        attach_alignment,
        eval_commands_recognition,
        generate_raw_audio_dataset,
        pretrain_gsc,
        stitch_vocab_samples,
        train,
    )
    from howl_tpu_torch.training.step import make_classification_train_step
    from howl_tpu_torch.workspace import Workspace

    print(bench.card_line())
    t_phase = time.perf_counter()
    out = {}
    with entry_workdir(), _restored_env(*GSC_RECIPE):
        # (a) Common Voice -> mined -> aligned -> stitched -> trained
        t0 = time.perf_counter()
        write_cv_corpus(Path("cv"), STITCH_CLIPS)
        generate_raw_audio_dataset.run(["-i", "cv", "--dataset-type", "common-voice", "-o", "datasets", "--overwrite"])
        root = Path("datasets", "hey_fire_fox")
        for kind in ("positive", "negative"):
            attach_alignment.run(["-i", str(root / kind), "--alignment-type", "stub"])
        random.seed(SEED)
        stitch_vocab_samples.run(["-i", str(root / "positive"), "--max-num-training-samples", str(STITCH_SAMPLES[0]),
                                  "--max-num-dev-samples", str(STITCH_SAMPLES[1]), "--max-num-test-samples",
                                  str(STITCH_SAMPLES[2]), "--disable-detect-keyword"])
        etl_s = time.perf_counter() - t0
        ctx = InferenceContext(vocab=["hey", "fire", "fox"])
        kw = dict(sample_rate=SAMPLE_RATE, mono=True, frame_labeler=ctx.labeler)
        raw = {kind: [len(ds) for ds in WakeWordDatasetLoader().load_splits(root / kind, **kw)]
               for kind in ("positive", "negative")}
        stitched = WakeWordDatasetLoader().load_splits(root / "positive", prefix="stitched-", **kw)
        labels_ok = all(sorted(ds[i].label_data.timestamp_label_map.values()) == [0, 1, 2]
                        for ds in stitched for i in range(len(ds)))
        print(f"17e (a) dataset pipeline on {STITCH_CLIPS} Common Voice-layout clips in {etl_s:.1f} s: aligned positives "
              f"{raw['positive']}, negatives {raw['negative']} (train, dev, test); stitched {[len(ds) for ds in stitched]}, "
              f"every one with its three word labels: {labels_ok}")
        if [len(ds) for ds in stitched] != list(STITCH_SAMPLES) or not labels_ok or not all(raw["positive"]):
            raise AssertionError(f"17e (a): stitched {[len(ds) for ds in stitched]} (labels {labels_ok}), raw {raw}")
        os.environ["NUM_EPOCHS"] = str(STITCH_EPOCHS)
        SETTINGS.reset()
        results, counts, stats = _train_entry(
            ["--model", "res8", "--workspace", "stitched_ws", "-i", str(root / "positive"), "--use-stitched-datasets",
             "--device", "cuda", "--eval-freq", "0", "--steps-per-epoch", str(ENTRY_STEPS)],
            "17e (a) res8 on the stitched dataset")
        loop_s = stats.prep_s + stats.step_s
        print(f"17e (a) {stats.steps / loop_s:.1f} steps/s, epoch losses {[round(x, 4) for x in stats.epoch_losses]}; "
              f"test positives fired {results['test_pos']['tp']} of {results['test_pos']['tp'] + results['test_pos']['fn']}, "
              f"noisy sweeps {sorted(k for k in results if 'noisy' in k)}")
        if stats.steps != STITCH_EPOCHS * ENTRY_STEPS or not np.isfinite(stats.epoch_losses).all() \
                or "test_noisy_pos" not in results:
            raise AssertionError(f"17e (a): {stats.steps} steps, losses {stats.epoch_losses}, results {sorted(results)}")
        out.update(k3_stitched=counts["k3"], k1_stitched=counts["k1"], k2_stitched=counts["k2"],
                   stitched_steps_per_s=stats.steps / loop_s)

        # (b) GSC pretraining at the protocol's widths
        write_gsc_corpus(Path(GSC_RECIPE["DATASET_PATH"]))
        os.environ.update(GSC_RECIPE)
        SETTINGS.reset()
        train_ds, dev_ds, test_ds = pretrain_gsc.load_splits(0.1)
        steps_per_epoch = len(train_ds) // GSC_BATCH
        runs = {}
        for tag, argv in (("single", ["--workspace", "gsc_ws", "--silence-proportion", "0.1"]),
                          ("sweep", ["--workspace", "gsc_sweep", "--silence-proportion", "0.1", "--sharded-seeds", "2",
                                     "--bf16"])):
            stats = train.LoopStats()
            _zero_launch_counts()
            result = pretrain_gsc.run(["--model", "res8", "--num-labels", "12", "--device", "cuda", *argv], stats)
            torch.cuda.synchronize()
            _gsc_counts(f"17e (b) pretrain_gsc {' '.join(argv[2:])}", stats, _launch_counts())
            print(f"17e (b) {tag}: {result}; epoch losses {stats.epoch_losses}")
            runs[tag] = (result, stats)
        result, stats = runs["single"]
        if stats.steps != GSC_EPOCHS * steps_per_epoch or not stats.epoch_losses[-1] < stats.epoch_losses[0] \
                or not result["test_acc"] > 1 / 12:
            raise AssertionError(f"17e (b): {stats.steps} steps, losses {stats.epoch_losses}, accuracies {result}")
        sweep, sweep_stats = runs["sweep"]
        if sorted(sweep) != ["dev_acc", "per_seed_dev_acc", "per_seed_test_acc", "test_acc"] or \
                not all(Path("gsc_sweep", f"seed_{s}", "model-best.pt").exists() for s in (0, 1)):
            raise AssertionError(f"17e (b) sweep: {sweep}")
        # each seed's first sweep step against its own single-model step at its key, on its batch
        audio, labels, lengths = next(pretrain_gsc.seed_batches(train_ds, 2, 0, dev))
        zmuv = Workspace(Path("gsc_sweep"), delete_existing=False).load_zmuv()
        model = create_model("res8", num_labels=12, dtype=torch.bfloat16)
        step = make_classification_train_step(model, pretrain_gsc.step_config("res8", zmuv, use_augment=True))
        singles = []
        for s in (0, 1):
            state = create_seed_states(model, [s], device=dev,
                                       **pretrain_gsc.optimizer_settings(steps_per_epoch))[0]
            singles.append(float(step(state, audio[s], labels[s], lengths[s], s)[1]["loss"]))
        print(f"17e (b) seed sweep: first-step losses {[repr(x) for x in sweep_stats.step_losses[0]]}, each seed's "
              f"single-model step at its key {[repr(x) for x in singles]}")
        if singles != sweep_stats.step_losses[0]:
            raise AssertionError(f"17e (b): the sweep's first-step losses {sweep_stats.step_losses[0]} are not the single "
                                 f"steps' {singles}")
        # the commands-recognition protocol: two seeds, each a pretrain_gsc run of GSC_PROTOCOL_EPOCHS epochs
        _zero_launch_counts()
        t0 = time.perf_counter()
        report = eval_commands_recognition.run(["--models", "res8", "-n", "2", "--epochs", str(GSC_PROTOCOL_EPOCHS),
                                                "--workspace", "gsc_protocol", "-i", GSC_RECIPE["DATASET_PATH"],
                                                "--device", "cuda"])
        torch.cuda.synchronize()
        counts = _launch_counts()
        dev_n, test_n = (len(ds.metadata_list) for ds in (dev_ds, test_ds))  # the protocol adds no silence
        eval_batches = 2 * (GSC_PROTOCOL_EPOCHS * math.ceil(dev_n / GSC_BATCH) + math.ceil(test_n / GSC_BATCH))
        print(f"17e (b) eval_commands_recognition -n 2 --epochs {GSC_PROTOCOL_EPOCHS}: {report['res8']} in "
              f"{time.perf_counter() - t0:.1f} s; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']}")
        rows = Path("gsc_protocol", "commands_recognition_report.csv").read_text().splitlines()
        if (counts["k1"], counts["k2"], counts["k3"]) != (0, eval_batches, 0) or len(report["res8"]["accuracies"]) != 2 \
                or rows[0] != "model,mean,std,p90,p95,p99" or not rows[1].startswith("res8,"):
            raise AssertionError(f"17e (b) protocol: launches {counts} ({eval_batches} eval batches), {report}, {rows}")
        out.update(k2_gsc=runs["single"][1].eval_batches, k2_gsc_sweep=sweep_stats.eval_batches, k2_protocol=counts["k2"],
                   gsc_steps_per_s=stats.steps / (stats.prep_s + stats.step_s),
                   sweep_steps_per_s=sweep_stats.steps / (sweep_stats.prep_s + sweep_stats.step_s))
    print(f"17e GSC pretraining and the dataset pipeline: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 17f: the exports, vision pretraining, the demo, profiling and scale-out. A CIFAR-10-layout corpus of
# PRETRAIN_IMAGES images (five train batches of 80, a test batch of 112) for PRETRAIN_EPOCHS epochs at batch
# PRETRAIN_BATCH; the sharded live engines at SHARD_STREAMS streams over SHARD_WAYS shards of one card; K2 at 32 mel
# rows timed at STEM32_BATCH images
PRETRAIN_IMAGES, PRETRAIN_EPOCHS, PRETRAIN_BATCH, STEM32_BATCH = (400, 112), 5, 32, 512
SHARD_STREAMS, SHARD_WAYS = 512, 2


def write_cifar10(root, n_train: int, n_test: int, seed: int = SEED):
    """A CIFAR-10 python-format directory: ``data_batch_1..5`` of ``n_train / 5`` images each and a ``test_batch``
    of ``n_test``, uint8 (N, 3072) rows and labels; class c brightens channel 0 by a ramp over the columns, so the
    classes separate."""
    import pickle
    from pathlib import Path

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, n in [(f"data_batch_{i}", n_train // 5) for i in range(1, 6)] + [("test_batch", n_test)]:
        labels = rng.integers(0, 10, n)
        x = rng.normal(100.0, 20.0, (n, 3, 32, 32))
        x[:, 0] += np.linspace(0.0, 1.0, 32)[None, None, :] * (labels[:, None, None] + 1) * 12.0
        with (root / name).open("wb") as f:
            pickle.dump({b"data": np.clip(x, 0, 255).astype(np.uint8).reshape(n, -1), b"labels": labels.tolist()}, f)
    return root


def trace_batch_main() -> int:
    """``python3 chip_smoke.py --trace-batch WS DIR``: the workspace's res8 as the hub's offline engine in bf16, one
    batch of ``BATCH`` random clips of ``CLIP_SECONDS`` warmed, then one traced by ``utils.profiling.trace`` into
    DIR; its last line is {"k1": K1's kernel names in the trace, "k2": K2's, "ms", "trace", "bytes"}."""
    from pathlib import Path

    import torch

    from howl_tpu_torch import hub
    from howl_tpu_torch.ops import _build
    from howl_tpu_torch.utils.profiling import StepTimer, trace

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py --trace-batch needs a CUDA device")
    workspace, out_dir = sys.argv[2], Path(sys.argv[3])
    _build.kernel_library()
    dev = torch.device("cuda", 0)
    engine, _ = hub.load_workspace_streaming_engine(workspace, device=dev, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randn((BATCH, int(CLIP_SECONDS * SAMPLE_RATE)), generator=gen, device=dev) * 0.1
    engine.infer_batch(batch)  # warm
    timer = StepTimer()
    with trace(out_dir) as prof, timer:
        engine.infer_batch(batch)
    # a kernel's key is its name, e.g. "(anonymous namespace)::stem_tc_kernel(...)" or "logmel_tc_kernel<40, 1>"
    names = {e.key.split("::")[-1].split("(")[0] for e in prof.key_averages()}
    print(json.dumps({"k1": sorted(n for n in names if n.startswith("logmel")),
                      "k2": sorted(n for n in names if n.startswith("stem_")), "ms": timer.summary()["mean_ms"],
                      "trace": str(prof.trace_path), "bytes": prof.trace_path.stat().st_size}))
    return 0


def check_stem_32(dev) -> dict:
    """K2 at 32 mel rows (vision pretraining's (B, 32, 32) images as (B, T, F) mels), a geometry no other phase runs:
    "fma" in float32 and bf16 and "tc" in bf16 against ``res8_stem_plain`` at the eval batch and at
    ``STEM32_BATCH``; at ``STEM32_BATCH`` in bf16 "tc", "fma" and plain timed in turns. Returns the record."""
    import torch

    from howl_tpu_torch.ops.frontend import round_bf16
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain, stem_route

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    taps = torch.randn((3, 3, 45), generator=gen, device=dev) / 3.0
    errs = {}
    for batch in (PRETRAIN_BATCH, STEM32_BATCH):
        images = torch.rand((batch, 32, 32), generator=gen, device=dev)
        for dtype, routes in ((torch.float32, ("fma",)), (torch.bfloat16, ("tc", "fma"))):
            mel = images.to(dtype).contiguous()
            w = round_bf16(taps) if dtype == torch.bfloat16 else taps
            ref = res8_stem_plain(mel, w)
            tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5
            for route in routes:
                got = res8_stem_cuda(mel, w, route=route)
                err = float((got.float() - ref.float()).abs().max())
                errs[batch, route, str(dtype)[6:]] = err
                if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()) or err > tol:
                    raise AssertionError(f"17f: K2 {route} {dtype} at {tuple(mel.shape)}: {tuple(got.shape)}, "
                                         f"max_abs_err {err:.3e} over {tol:.3e}")
    if (stem_route(torch.float32, 32, 45), stem_route(torch.bfloat16, 32, 45)) != ("fma", "tc"):
        raise AssertionError("17f: the stem routes at 32 mel rows are not fma (float32) and tc (bf16)")
    mel = images.to(torch.bfloat16).contiguous()
    w = round_bf16(taps)
    turns = [_cuda_ms(lambda: res8_stem_plain(mel, w), 20), _cuda_ms(lambda: res8_stem_cuda(mel, w, route="fma"), 20),
             _cuda_ms(lambda: res8_stem_cuda(mel, w, route="tc"), 20), _cuda_ms(lambda: res8_stem_cuda(mel, w, route="tc"), 20),
             _cuda_ms(lambda: res8_stem_cuda(mel, w, route="fma"), 20), _cuda_ms(lambda: res8_stem_plain(mel, w), 20)]
    out = res8_stem_cuda(mel, w)
    ops = mel.numel() * 45 * 9 * 2 + out.numel() * 12
    record = {"ms": (turns[2] + turns[3]) / 2, "fma_ms": (turns[1] + turns[4]) / 2, "plain_ms": (turns[0] + turns[5]) / 2,
              "max_abs_err": max(errs.values()), **_bound(_nbytes(mel, w, out), ops, PEAK_BF16_FLOPS)}
    print(f"17f K2 at (B, 32, 32): max_abs_err {', '.join(f'{k[1]} {k[2]} B={k[0]} {v:.3e}' for k, v in errs.items())}; "
          f"bf16 at B={STEM32_BATCH}: tc {record['ms']:.4f} ms, fma {record['fma_ms']:.4f} ms, plain "
          f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms by {record['bound_by']}")
    return record


def _printed(fn, argv) -> tuple:
    """(fn(argv), the lines it printed), the lines echoed with a prefix."""
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        result = fn(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"    | {line}")
    return result, lines


def drive_exports_and_scaleout(dev, state_dict, zmuv: dict) -> dict:
    """(17f) On phase 17's trained res8, in its working directory: (a) ``utils.profiling.trace`` around one offline
    bf16 batch in a process of its own (``trace_batch_main``), whose trace must name K1's and K2's kernels; (b) K1 on the Meyda basis (22,050 Hz, f_max 8 kHz, 40
    mels, exact grade) against ``MeydaMelSpectrogram`` (rtol 1e-3, atol 1e-4 in the exp domain); (c)
    ``export_honkling`` of the trained weights equal to the dump made on the host; (d) ``pretrain`` on a CIFAR-layout
    corpus: K2 at 32 mel rows (``check_stem_32``) and once an eval batch; (e) ``demo --streams 4 --incremental``
    (K2 once a tick) and the single-stream demo (K1 and K2 once a hop); (f) the three live engines at
    ``SHARD_STREAMS`` streams sharded ``SHARD_WAYS`` ways on the one card, deciding as the unsharded engines on every
    hop, K1 and K2 once a hop a shard where the engine launches them; (g) ``train --num-devices 2`` on NCCL against
    ``--num-devices 1`` where two cards are visible. Returns the launch counts and K2's record at 32 rows."""
    import os
    from pathlib import Path

    import torch

    from howl_tpu_torch import hub
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.meyda import MeydaMelSpectrogram
    from howl_tpu_torch.parallel.mesh import make_mesh
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import demo, export_honkling, pretrain, train

    print(bench.card_line())
    t_phase = time.perf_counter()
    out = {}
    with entry_workdir() as tmp:
        tmp = Path(tmp)
        port_ws, _ = _serving_workspaces(tmp, state_dict, zmuv)
        # (a) one offline batch under the profiler, in a process of its own, where no earlier session drops the
        # first device records (F18; phase 17g holds ``trace`` in this process)
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trace-batch", str(port_ws.resolve()),
                               str(tmp / "trace")], cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"17f (a): the traced batch failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        traced = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"17f (a) trace of one bf16 batch of {BATCH} clips of {CLIP_SECONDS:g} s in a process of its own "
              f"({traced['ms']:.1f} ms): {Path(traced['trace']).name}, {traced['bytes']} bytes; K1 {traced['k1']}, "
              f"K2 {traced['k2']}")
        if not (traced["k1"] and traced["k2"]):
            raise AssertionError(f"17f (a): the trace names no K1 or no K2 kernel: {traced}")
        _, ww_dev, ww_test = WakeWordDatasetLoader().load_splits(Path("ww"), sample_rate=SAMPLE_RATE, mono=True)
        clips = np.stack([ds[i].audio_data for ds in (ww_dev, ww_test) for i in range(len(ds))])
        # (b) K1 on the Meyda basis
        cfg = FrontendConfig(sample_rate=22050, n_fft=512, hop_length=200, n_mels=40, f_max=8000.0)
        audio = (np.random.default_rng(SEED).standard_normal((4, 22050)) * 0.1).astype(np.float32)
        _zero_launch_counts()
        dev_mels = log_mel_spectrogram_cuda(torch.from_numpy(audio).to(dev), cfg, precision="highest")
        torch.cuda.synchronize()
        k1_meyda = _launch_counts()["k1"]
        host = MeydaMelSpectrogram(n_fft=512, n_mels=40, sample_rate=22050, hop_length=200)(audio)
        got = np.exp(dev_mels.cpu().numpy())
        err = float(np.max(np.abs(got - host) / (1e-4 + 1e-3 * np.abs(host))))
        print(f"17f (b) K1 ({k1_meyda} launch) on the Meyda basis (22,050 Hz, f_max 8 kHz, 40 mels): {got.shape}, "
              f"max |diff| / (atol + rtol |meyda|) = {err:.3f}")
        if k1_meyda != 1 or got.shape != host.shape or not err <= 1.0:
            raise AssertionError(f"17f (b): K1 on the Meyda basis disagrees with MeydaMelSpectrogram ({err:.3f})")
        # (c) the honkling export
        export_honkling.run(["-i", str(port_ws), "-o", "weights.js", "--name", "RES8", "--model", "res8"])
        want = "weights['RES8'] = " + json.dumps(export_honkling.honkling_dict(
            "res8", "RES8", {k: v.detach().cpu() for k, v in state_dict.items()}))
        same = Path("weights.js").read_text() == want
        print(f"17f (c) export_honkling: {Path('weights.js').stat().st_size} bytes, equal to the host's dump: {same}")
        if not same:
            raise AssertionError("17f (c): export_honkling's file is not the host's dump")
        # (d) vision pretraining
        out["stem_32"] = check_stem_32(dev)
        write_cifar10(Path("cifar"), *PRETRAIN_IMAGES)
        with _restored_env("NUM_EPOCHS", "BATCH_SIZE"):
            os.environ.update({"NUM_EPOCHS": str(PRETRAIN_EPOCHS), "BATCH_SIZE": str(PRETRAIN_BATCH)})
            SETTINGS.reset()
            _zero_launch_counts()
            t0 = time.perf_counter()
            result = pretrain.run(["--model", "res8", "--workspace", "pretrain_ws", "-i", "cifar", "--device", "cuda"])
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
        SETTINGS.reset()
        counts = _launch_counts()
        eval_batches = PRETRAIN_IMAGES[1] // PRETRAIN_BATCH
        print(f"17f (d) pretrain on {sum(PRETRAIN_IMAGES)} CIFAR-layout images, {PRETRAIN_EPOCHS} epochs at batch "
              f"{PRETRAIN_BATCH} in {pre_s:.1f} s: test_acc {result['test_acc']:.4f}; K2 {counts['k2']} launches "
              f"(tc {counts['k2_tc']}) for {eval_batches} eval batches, K1 {counts['k1']}, K3 {counts['k3']}")
        if (counts["k2"], counts["k2_tc"], counts["k1"], counts["k3"]) != (eval_batches, 0, 0, 0) or \
                not Path("pretrain_ws", "model-best.pt").exists() or not 0.0 <= result["test_acc"] <= 1.0:
            raise AssertionError(f"17f (d): launches {counts}, result {result}")
        out["k2_pretrain"] = counts["k2"]
        # (e) the demo, four streams on the incremental engine, then one stream through the client
        wavs = [str(Path("ww", "audio", name)) for name in ("pos_000.wav", "pos_002.wav", "neg_000.wav", "neg_002.wav")]
        _zero_launch_counts()
        server, lines = _printed(demo.run, ["--workspace", str(port_ws), "--wav", *wavs, "--streams", "4",
                                            "--incremental", "--device", "cuda"])
        torch.cuda.synchronize()
        counts = _launch_counts()
        print(f"17f (e) demo --streams 4 --incremental: {server.ticks} ticks, detections {server.detections.tolist()}; "
              f"K1 {counts['k1']}, K2 {counts['k2']} launches")
        if (counts["k1"], counts["k2"]) != (0, server.ticks) or not lines[-1].startswith("served 4 streams"):
            raise AssertionError(f"17f (e): demo --streams: K1 {counts['k1']}, K2 {counts['k2']} for {server.ticks} ticks")
        out["demo_streams"] = counts
        _zero_launch_counts()
        _, lines = _printed(demo.run, ["--workspace", str(port_ws), "--wav", wavs[0], "--device", "cuda"])
        torch.cuda.synchronize()
        counts = _launch_counts()
        print(f"17f (e) demo, one stream through HowlClient: {sum('detected' in x for x in lines)} detection lines; "
              f"K1 {counts['k1']}, K2 {counts['k2']} launches (one of each a hop)")
        if counts["k1"] != counts["k2"] or not counts["k1"]:
            raise AssertionError(f"17f (e): the single-stream demo launched K1 {counts['k1']}, K2 {counts['k2']}")
        out["demo_client"] = counts
        # (f) the live engines sharded over one card
        reps = -(-SHARD_STREAMS // len(clips))
        pad = int(SERVE_PAD_S * SAMPLE_RATE)
        live = torch.from_numpy(np.pad(np.tile(clips, (reps, 1))[:SHARD_STREAMS], ((0, 0), (0, pad)))).to(dev)
        mesh = make_mesh(data=SHARD_WAYS, devices=[dev] * SHARD_WAYS)
        out["sharded"] = {}
        for kind, flags in (("online", {}), ("incremental", {"incremental": True}),
                            ("trunk", {"streaming_trunk": True})):
            base, _ = hub.load_workspace_engine(port_ws, num_streams=SHARD_STREAMS, device=dev, **flags)
            sharded, _ = hub.load_workspace_engine(port_ws, num_streams=SHARD_STREAMS, device=dev, **flags)
            sharded.shard_streams(mesh)
            want = _feed_live(base, live)
            _zero_launch_counts()
            t0 = time.perf_counter()
            got = _feed_live(sharded, live)
            torch.cuda.synchronize()
            hop_ms = (time.perf_counter() - t0) * 1e3 / len(got)
            counts = _launch_counts()
            hops = len(got)
            per_hop = {"online": (1, 1), "incremental": (0, 1), "trunk": (0, 0)}[kind]
            print(f"17f (f) {kind} engine, {SHARD_STREAMS} streams in {SHARD_WAYS} shards on {dev}: {hops} hops, "
                  f"{hop_ms:.2f} ms a hop; decisions equal to the unsharded engine's on every hop: "
                  f"{bool(np.array_equal(got, want))} ({int(want.sum())} fires); K1 {counts['k1']}, K2 {counts['k2']}")
            if not np.array_equal(got, want) or (counts["k1"], counts["k2"]) != (
                    per_hop[0] * SHARD_WAYS * hops, per_hop[1] * SHARD_WAYS * hops):
                raise AssertionError(f"17f (f) {kind}: decisions equal {np.array_equal(got, want)}, launches {counts} "
                                     f"for {hops} hops of {SHARD_WAYS} shards")
            out["sharded"][kind] = {"k1": counts["k1"], "k2": counts["k2"], "hops": hops, "hop_ms": hop_ms}
        # (g) data parallelism over two cards
        if torch.cuda.device_count() >= 2:
            with _restored_env("NUM_EPOCHS"):
                os.environ["NUM_EPOCHS"] = "2"
                SETTINGS.reset()
                losses = {}
                for n in (1, 2):
                    stats = train.LoopStats()
                    train.run(["--model", "res8", "--workspace", f"dp{n}", "-i", "ww", "--device", "cuda", "--eval-freq",
                               "0", "--steps-per-epoch", str(ENTRY_STEPS), "--num-devices", str(n)], stats)
                    losses[n] = stats.epoch_losses
            SETTINGS.reset()
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses[2], losses[1]))
            print(f"17f (g) train --num-devices 2 (NCCL) against 1, 2 epochs: {losses[2]} vs {losses[1]}, max rel {rel:.2e}")
            if not rel <= 5e-3:
                raise AssertionError(f"17f (g): two ranks' epoch losses {losses[2]} are not one process's {losses[1]}")
        else:
            print(f"17f (g) train --num-devices 2 did not run: this host shows {torch.cuda.device_count()} card "
                  "(NCCL puts no two ranks on one card); two ranks ran on the CPU only (tests/test_torch_scaleout.py)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"17f exports, vision pretraining, the demo, profiling and scale-out: {out['seconds']:.1f} s")
    return out


# phase 17g: the harness's two-seed sweep in one process and on a (seed GRID_SEEDS, data GRID_DATA) grid, GRID_EPOCHS
# epochs of ENTRY_STEPS sweep steps each; the first step's per-seed losses within GRID_FIRST_RTOL (the CPU grid test's
# one-step tolerance), every epoch's within GRID_EPOCH_RTOL (item 12's gate)
GRID_SEEDS, GRID_DATA, GRID_EPOCHS, GRID_FIRST_RTOL, GRID_EPOCH_RTOL = 2, 2, 2, 1e-5, 5e-3
# F18's check: a profiler session of F18_LAUNCHES launches, then sessions around F18_LADDER K1 launches
F18_LAUNCHES, F18_LADDER = 60000, 20


def check_profiler_sessions(dev, out_dir) -> dict:
    """F18: a ``torch.profiler`` session of ``F18_LAUNCHES`` one-element adds in this process, after which PyTorch's
    profiler drops device records at the start of every later session; then a plain session around a ladder of
    ``F18_LADDER`` K1 launches (each waited for, 2 ms apart), whose recorded K1 kernels are printed, the control;
    then two ``utils.profiling.trace`` sessions around the same ladder, each of which must record every K1 launch
    (its primer takes the dropped records; each prints how many of the primer's it lost). Returns the counts."""
    import torch

    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.utils.profiling import trace

    audio = torch.randn((8, SAMPLE_RATE), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev) * 0.1
    cfg = FrontendConfig(n_mels=N_MELS)
    cuda = torch.autograd.DeviceType.CUDA
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def ladder() -> None:
        for _ in range(F18_LADDER):
            log_mel_spectrogram_cuda(audio, cfg)
            torch.cuda.synchronize()
            time.sleep(0.002)

    def k1_kernels(prof) -> int:
        return sum(1 for e in prof.events() if e.device_type == cuda and e.name.split("::")[-1].startswith("logmel"))

    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities):
        x = torch.zeros(1, device=dev)
        for _ in range(F18_LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=activities) as prof:
        ladder()
    out = {"control": k1_kernels(prof), "trace": [], "lost_at_start": []}
    print(f"17g F18: after a profiler session of {F18_LAUNCHES:,} launches in this process ({long_s:.1f} s), a plain "
          f"session around {F18_LADDER} K1 launches recorded {out['control']} of them (the control)")
    for session in range(2):
        with trace(out_dir) as prof:
            ladder()
        out["trace"].append(k1_kernels(prof))
        out["lost_at_start"].append(prof.lost_at_start)
        print(f"17g F18: trace session {session + 1} of 2 recorded {out['trace'][-1]} of {F18_LADDER} K1 launches; "
              f"the primer's launches lost at the session's start {prof.lost_at_start}; {prof.trace_path.name}, "
              f"{prof.trace_path.stat().st_size} bytes")
    if out["trace"] != [F18_LADDER] * 2:
        raise AssertionError(f"17g F18: a trace session lost K1 launches: {out['trace']} of {F18_LADDER} each")
    return out


def drive_seed_grid(dev) -> dict:
    """(17g) On phase 17's corpora (``entry_workdir``), res8 in float32: the harness's two-seed sweep,
    ``eval_wake_word_detection.run -n 2 --sharded-seeds``, ``GRID_EPOCHS`` epochs of ``ENTRY_STEPS`` sweep steps, in
    one process, then through ``run(..., mesh=)`` on a (seed 2, data 2) grid of four ranks that share ``dev`` (gloo
    over CUDA tensors): each rank's K3 launches (one a sweep step over its rows) and K1 and K2 launches (one an
    evaluator batch of its seed's threshold sweeps, every rank scoring batches), and each seed's losses against the
    one-process sweep (the first step within ``GRID_FIRST_RTOL``, every epoch within ``GRID_EPOCH_RTOL``), the two
    runs' report counts compared. Where four cards are visible the grid runs again on distinct cards over NCCL;
    otherwise a line says it did not run. Then F18's check (``check_profiler_sessions``). Prints the phase's seconds
    and the card's name and power limit; returns the launch counts."""
    import os

    import torch

    from howl_tpu_torch.parallel.mesh import make_mesh, mesh_backend, visible_cards
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import eval_wake_word_detection as harness
    from howl_tpu_torch.training.run import train

    print(bench.card_line())
    t_phase = time.perf_counter()
    out = {}
    meshes = [("shared", make_mesh(seed=GRID_SEEDS, data=GRID_DATA, devices=[dev] * (GRID_SEEDS * GRID_DATA)))]
    cards = visible_cards()
    if len(cards) >= GRID_SEEDS * GRID_DATA:
        meshes.append(("distinct", make_mesh(seed=GRID_SEEDS, data=GRID_DATA, devices=cards)))
    with entry_workdir() as tmp:
        os.environ["NUM_EPOCHS"] = str(GRID_EPOCHS)
        SETTINGS.reset()
        argv = ["-i", "ww", "-n", str(GRID_SEEDS), "--sharded-seeds", "--steps-per-epoch", str(ENTRY_STEPS),
                "--device", "cuda"]
        t0 = time.perf_counter()
        one = harness.run(argv + ["--workspace", "one"], train.LoopStats())
        one_s = time.perf_counter() - t0
        want = one["train"]
        print(f"17g one process: {want['steps']} sweep steps of {GRID_SEEDS} seeds in {one_s:.1f} s; per-seed epoch "
              f"losses {want['epoch_losses']}")
        for tag, mesh in meshes:
            _zero_launch_counts()
            t0 = time.perf_counter()
            got = harness.run(argv + ["--workspace", f"grid_{tag}"], train.LoopStats(), mesh=mesh)
            torch.cuda.synchronize()
            grid_s = time.perf_counter() - t0
            record = got["train"]
            shared = len(set(mesh.device_list())) < mesh.size
            print(f"17g grid ({tag}): seed {GRID_SEEDS} x data {GRID_DATA} = {mesh.size} ranks on "
                  f"{[str(d) for d in mesh.device_list()]}, backend {mesh_backend(mesh)}"
                  + (f" over CUDA tensors: the ranks share {dev}" if shared else ": one card a rank")
                  + f"; {record['steps']} sweep steps in {grid_s:.1f} s (with the ranks' start and the sweeps)")
            for rank, counts in enumerate(record["ranks"]):
                print(f"17g grid ({tag}) rank {rank} (seed {rank // GRID_DATA}, data {rank % GRID_DATA}): K3 "
                      f"{counts['k3']} launches for {record['steps']} sweep steps; K1 {counts['k1']}, "
                      f"K2 {counts['k2']} for {counts['eval_batches']} evaluator batches")
                if counts["k3"] != record["steps"] or not counts["eval_batches"] or \
                        (counts["k1"], counts["k2"]) != (counts["eval_batches"], counts["eval_batches"]):
                    raise AssertionError(f"17g grid ({tag}) rank {rank}: launches {counts} for {record['steps']} steps")
            first = np.abs(record["step_losses"][0] - want["step_losses"][0]) / np.abs(want["step_losses"][0])
            epoch = np.abs(np.asarray(record["epoch_losses"]) - want["epoch_losses"]) / np.abs(want["epoch_losses"])
            same_counts = got["per_seed"] == one["per_seed"]
            print(f"17g grid ({tag}) against one process: first-step per-seed losses "
                  f"{record['step_losses'][0].tolist()} vs {want['step_losses'][0].tolist()} (max rel "
                  f"{first.max():.2e}); per-seed epoch losses "
                  f"{record['epoch_losses']} (max rel {epoch.max():.2e}); every report count equal at every threshold: "
                  f"{same_counts}")
            if not (first.max() <= GRID_FIRST_RTOL and epoch.max() <= GRID_EPOCH_RTOL):
                raise AssertionError(f"17g grid ({tag}): the per-seed losses are not the one-process sweep's "
                                     f"(first step {first.max():.2e}, epochs {epoch.max():.2e})")
            out[tag] = {"ranks": record["ranks"], "seconds": grid_s, "first_rel": float(first.max()),
                        "epoch_rel": float(epoch.max()), "counts_equal": same_counts}
        SETTINGS.reset()
        if len(meshes) == 1:
            print(f"17g grid (distinct): NCCL on four distinct cards did not run: this host shows {len(cards)} card(s)")
        out["f18"] = check_profiler_sessions(dev, tmp / "f18")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"17g the seed sweep on a (seed, data) grid and F18: {out['seconds']:.1f} s")
    return out


def drive_families_train(dev) -> dict:
    """(17b) Each of the seven other families trained through the entry point on the card with ``--bf16`` (flax's
    mixed precision over float32 masters), on phase 17's tone corpus and recipe (``entry_workdir``: the noise corpus
    and augmentation on), ``FAMILY_TRAIN_EPOCHS`` epochs of ``ENTRY_STEPS`` steps: the sequential models (seq-cnn,
    seq-lstm) under the CTC objective, the others under the frame objective, and small-cnn once more under
    ``CONVERT_STATIC`` (CTC). Around each run the launch counts are zeroed and read: K3 once a train step, K1 once an
    evaluator batch (las never; K1 at the exact grade, on "tc" where ``frontend_route`` serves it), K2 never. F9 on
    the weights each run trained: the bf16 engine (K1 at "bf16") must detect as the exact float32 engine on every dev
    and test clip. Prints each run's epochs, first and final loss, steps/s, the dev positives that fired and the max
    |dprob| of F9. Returns {run: record}."""
    import os
    from dataclasses import replace
    from pathlib import Path

    import torch

    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.inference.config import EngineConfig
    from howl_tpu_torch.inference.engine import StreamingEngine
    from howl_tpu_torch.models import ConvertedStaticModel, create_model, model_spec
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route
    from howl_tpu_torch.settings import SETTINGS

    print(bench.card_line())
    runs = [(name, model_spec(name).is_sequential, False) for name in FAMILY_NAMES] + [("small-cnn", True, True)]
    out = {}
    with entry_workdir(), _restored_env("OBJECTIVE", "CONVERT_STATIC"):
        corpus = "ww"
        _, ww_dev, ww_test = WakeWordDatasetLoader().load_splits(corpus, sample_rate=SAMPLE_RATE, mono=True)
        audio = np.stack([ds[i].audio_data for ds in (ww_dev, ww_test) for i in range(len(ds))])
        k1_tc = int(frontend_route(FrontendConfig.from_settings(), "f32") == "tc")
        for name, ctc, convert in runs:
            tag = f"{name}{' CONVERT_STATIC' if convert else ''}{' (ctc)' if ctc else ''}"
            os.environ.update({"NUM_EPOCHS": str(FAMILY_TRAIN_EPOCHS), "OBJECTIVE": "ctc" if ctc else "frame",
                               "CONVERT_STATIC": str(convert).lower()})
            SETTINGS.reset()
            spec = model_spec(name)
            ws = f"ws_{name}{'_static' if convert else ''}"
            results, counts, stats = _train_entry(
                ["--model", name, "--workspace", ws, "-i", corpus, "--device", "cuda", "--bf16", "--eval-freq", "0",
                 "--steps-per-epoch", str(ENTRY_STEPS)], f"{tag} --bf16", k1=not spec.uses_deltas, k2=False)
            if counts["k1_tc"] != k1_tc * counts["k1"]:
                raise AssertionError(f"{tag}: the evaluator's K1 at the exact grade not on {'tc' if k1_tc else 'fma'}: {counts}")
            # F9 on the weights this run trained
            ctx = InferenceContext(vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type, use_blank=ctc)
            zmuv = json.loads(Path(ws, "zmuv.json").read_text())
            mean, std = zmuv["mean"], float(np.sqrt(zmuv["mean2"] - zmuv["mean"] ** 2))
            model = create_model(name, num_labels=ctx.num_labels)
            if convert:
                model, spec = ConvertedStaticModel(model, 40, 10), replace(spec, is_sequential=True)
            state_dict = torch.load(f"{ws}/model.pt", weights_only=True)
            f9 = {grade: StreamingEngine(model, state_dict, EngineConfig.from_settings(ctx), FrontendConfig.from_settings(),
                                         mean, std, spec=spec, compute_dtype=dtype, frontend_precision=grade,
                                         device=dev).infer_batch(audio)
                  for grade, dtype in (("f32", None), ("bf16", torch.bfloat16))}
            equal = torch.equal(f9["f32"]["detected"].cpu(), f9["bf16"]["detected"].cpu())
            dprob = float((f9["bf16"]["probs"] - f9["f32"]["probs"]).abs().max())
            # F9 is held only where the float32 engine decides both ways: it fires on some clips and not on others
            fired = int(f9["f32"]["detected"].sum())
            held = 0 < fired < len(audio)
            word_max = float(f9["f32"]["probs"][..., : ctx.negative_label].max())
            loop_s = stats.prep_s + stats.step_s
            rec = {"epochs": len(stats.epoch_losses), "steps": stats.steps, "first_loss": stats.epoch_losses[0],
                   "final_loss": stats.epoch_losses[-1], "steps_per_s": stats.steps / loop_s, "k3_launches": counts["k3"],
                   "dev_pos_fired": results["dev_pos"]["tp"], "dev_pos": results["dev_pos"]["tp"] + results["dev_pos"]["fn"],
                   "f9_equal": equal, "f9_max_dprob": dprob, "f9_held": held, "f9_fired": fired}
            print(f"{tag} --bf16: {rec['epochs']} epochs of {ENTRY_STEPS} steps, loss {rec['first_loss']!r} -> "
                  f"{rec['final_loss']!r}, {rec['steps_per_s']:.1f} steps/s; dev positives fired {rec['dev_pos_fired']} of "
                  f"{rec['dev_pos']}, dev negatives fired {results['dev_neg']['fp']}; F9 on the trained weights, "
                  f"{len(audio)} dev and test clips ({fired} fire): bf16 detections "
                  f"{'equal' if equal else 'DIFFER FROM'} float32's, max |dprob| {dprob:.3e}; F9 "
                  + ("held" if held else f"NOT HELD: the float32 engine fires on {fired} of {len(audio)} clips, its "
                     f"largest word posterior {word_max!r}, so no decision lies at the threshold"))
            if not np.isfinite(stats.epoch_losses).all():
                raise AssertionError(f"{tag}: a loss that is not finite: {stats.epoch_losses}")
            if not equal:
                raise AssertionError(f"{tag}: F9: the bf16 engine's detections differ from the float32 engine's")
            out[tag] = rec
    print("F9 on the families' trained weights: held for " + (", ".join(t for t, r in out.items() if r["f9_held"]) or "none")
          + "; not held (no decision both ways) for " + (", ".join(t for t, r in out.items() if not r["f9_held"]) or "none"))
    return out


def _k1_counts() -> dict:
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda as k1

    return {"k1": k1.launches, "k1_tc": k1.launches_tc, **{f"{r}{t}": n for (r, t), n in k1.launches_by_tile.items()}}


def _zero_k1_counts() -> None:
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda as k1

    k1.launches = k1.launches_tc = 0
    k1.launches_by_tile.clear()


def drive_frontend_tiles_and_tools(dev) -> dict:
    """Phase 18: (a) ``check_frontend_tiles`` at 512 x 8 s and on 3 odd clips; (b) the three frontend tools at full
    size, K1's counters zeroed before each and read after; (c) ``bench_train`` at its card sizes. Returns
    {"tiles": the instances' records, "launches": {tool: counts}, "bench_train": its three records, "seconds"}."""
    import io
    import math

    import torch

    from howl_tpu_torch import bench_train
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_plain
    from howl_tpu_torch.tools import bench_frontend_tail_1pass, bench_frontend_variants, sweep_frontend_blocks

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    audio = torch.randn((BATCH, int(CLIP_SECONDS * SAMPLE_RATE)), generator=gen, device=dev) * 0.1
    odd = torch.randn((3, 30001), generator=gen, device=dev) * 0.1
    cfg = FrontendConfig(n_mels=N_MELS)
    ref = log_mel_spectrogram_plain(audio, cfg, precision="f32")
    tiles = check_frontend_tiles(audio, cfg, (float(ref.mean()), float(ref.std())), odd)
    del ref, audio, odd
    refused = {(r, t) for (r, t), rec in tiles.items() if len(rec["grades"]) < 4}
    if refused != {("tc", 256), ("fma", 64)} or tiles["fma", 64]["grades"] != ["f32", "bf16x2", "bf16"]:
        raise AssertionError(f"K1's refused instances are not the reckoned ones: {sorted(refused)}")
    print(f"18 (a) K1's tiles checked: {time.perf_counter() - t_phase:.1f} s")

    launches = {}
    for name, tool, argv, want in (
        ("sweep_frontend_blocks", sweep_frontend_blocks, [], [f"tc{t}" for t in (64, 128, 256)]
         + [f"fma{t}" for t in (16, 32, 64)]),
        ("bench_frontend_variants", bench_frontend_variants, [], [f"tc{t}" for t in (64, 128, 256)]),
        ("bench_frontend_tail_1pass", bench_frontend_tail_1pass, [], ["tc128", "tc256"]),
    ):
        _zero_k1_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            results = tool.main(["--device", "cuda", *argv])
        counts = _k1_counts()
        print(out.getvalue().rstrip())
        print(f"18 (b) {name}: {time.perf_counter() - t0:.1f} s; K1 launches {json.dumps(counts)}")
        if not all(counts.get(key, 0) > 0 for key in want) or counts["k1"] == 0:
            raise AssertionError(f"{name} did not launch each K1 instance it names ({want}): {counts}")
        if not all(isinstance(v, (str, dict)) or (math.isfinite(v) and v > 0) for v in results.values()):
            raise AssertionError(f"{name}: a leg's time is not finite and positive: {results}")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise AssertionError(f"{name} left TF32 on")
        launches[name] = counts

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        records = bench_train.main(["--device", "cuda"])
    print(out.getvalue().rstrip())
    for rec, batch in zip(records, (128, 128, 1024)):
        if not (rec["unit"] == f"steps_per_sec_batch{batch}" and math.isfinite(rec["value"]) and rec["value"] > 0
                and math.isfinite(rec["final_loss"])):
            raise AssertionError(f"bench_train: {rec}")
    print(f"18 (c) bench_train: {time.perf_counter() - t0:.1f} s")
    seconds = time.perf_counter() - t_phase
    print(f"18 K1's frame tiles and the last root tools: {seconds:.1f} s")
    return {"tiles": tiles, "launches": launches, "bench_train": records, "seconds": seconds}


def check_bench_record(record: dict) -> None:
    """(d) The bench's line: every measured key finite and positive with a
    [min, max] spread around it, the seven online keys included (the
    latencies at every stream count of ``bench.py``), the card named, and
    the int8 trunk's rung naming the fused kernel, one launch a batch."""
    measured = ("value", "mfu", "legacy_realtime_factor", "train_examples_per_sec", "train_mfu",
                "train_noise_examples_per_sec", "train_examples_per_sec_f32")
    for key in measured:
        value, spread = record[key], record["spread"][key]
        if value is None or not (np.isfinite(value) and value > 0):
            raise AssertionError(f"the bench's {key} is {value}")
        if spread is None or not (np.isfinite(spread).all() and 0 < spread[0] <= spread[1]):
            raise AssertionError(f"the bench's {key} has the spread {spread}")
    if not (record["mfu"] < 1 and record["train_mfu"] < 1):
        raise AssertionError(f"utilizations above the peak: mfu {record['mfu']}, train_mfu {record['train_mfu']}")
    if not record["device"]:
        raise AssertionError("the bench's device must be named")
    int8 = record["rungs"]["int8"]
    want = {"int8_fused": 1, "int8_layer": 0}  # the int8 trunk's route at the serving geometry: one fused launch
    if int8["route"] != "fused" or int8["launches_per_batch"] != want:
        raise AssertionError(f"the bench's int8 trunk ran {int8['route']!r} {int8['launches_per_batch']}, not {want}")
    counts = {"online_step_latency_ms": bench.CARD.online.latency_counts}
    for key in bench.ONLINE_KEYS:
        value, spread = record[key], record["spread"].get(key)
        if key.startswith("online_streams"):
            if not (isinstance(value, int) and value > 0 and spread and 0 < spread[0] <= spread[1]):
                raise AssertionError(f"the bench's {key} is {value} (spread {spread})")
            continue
        want = [str(n) for n in counts.get(key, bench.CARD.online.trunk_counts)]
        if value is None or list(value) != want or any(not (0 < v["p50"] <= v["p99"]) for v in value.values()):
            raise AssertionError(f"the bench's {key} is {value}")
    print(f"bench: realtime factor {record['value']} (legacy {record['legacy_realtime_factor']}), mfu {record['mfu']}, "
          f"train {record['train_examples_per_sec']} ex/s (mfu {record['train_mfu']}); online streams "
          f"{record['online_streams_per_chip']} (full window {record['online_streams_full_window']}, trunk "
          f"{record['online_streams_per_chip_trunk']}, blocked {record['online_streams_per_chip_trunk_blocked']}); "
          f"step latency {record['online_step_latency_ms']}")


def _profile(out_dir, file_name: str, title: str, stages: dict, batch_fn, n_batches: int) -> None:
    """Each stage's ms (CUDA events, 3 repeats of 10 calls), then a
    torch.profiler kernel table with the device's idle share over
    ``n_batches`` calls of ``batch_fn``, into ``out_dir/file_name``."""
    import torch

    lines = [f"{title}; stage ms (CUDA events, 3 x 10 calls)"]
    for name, fn in stages.items():
        times = [_cuda_ms(fn, 10) for _ in range(3)]
        lines.append(f"  {name}: " + ", ".join(f"{t:.3f}" for t in times))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            batch_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    lines.append(f"profiled {n_batches} calls: wall {wall_ms:.3f} ms, device busy {busy_us / 1000:.3f} ms, "
                 f"idle share {1 - busy_us / 1000 / wall_ms:.3f}")
    lines.append(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / file_name).write_text("\n".join(lines) + "\n")
    print("\n".join(lines[: len(stages) + 2]), flush=True)


def profile_train_step(dev, out_dir) -> None:
    """Stage times (CUDA events) of the bf16 noise-bank train step, and a
    torch.profiler kernel table over 5 steps, into ``out_dir/train_profile.txt``."""
    import torch

    from howl_tpu_torch.ops import augment as aug
    from howl_tpu_torch.training import step as st
    from howl_tpu_torch.training.objectives import frame_ce_loss

    audio, labels, bank, cfg, state_for = _train_setup(dev)
    model, state = state_for(torch.bfloat16)
    noise_step = st.make_classification_train_step(model, cfg, bank)
    prep = noise_step.prepared_for(TRAIN_WINDOW, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = st.draw_step(gen, cfg, TRAIN_BATCH, TRAIN_WINDOW, prep)
    mixed, _ = aug.apply_augment_audio(audio, draws.augment, cfg.augment, prep)
    feats = aug.apply_spec_augment(st.featurize(mixed, cfg, draws.vtlp_alpha), draws.spec)
    model.train()

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=True)
        frame_ce_loss(model(feats), labels).backward()

    fwd_bwd()
    stages = {
        "draws": lambda: st.draw_step(gen, cfg, TRAIN_BATCH, TRAIN_WINDOW, prep),
        "noise-bank mix (K3)": lambda: aug.apply_mix_noise_bank(audio, prep, draws.augment.mix),
        "augment chain (mix, shift, white, salt-pepper)": lambda: aug.apply_augment_audio(audio, draws.augment, cfg.augment, prep),
        "featurize (VTLP log-mel, ZMUV)": lambda: st.featurize(mixed, cfg, draws.vtlp_alpha),
        "spec augment": lambda: aug.apply_spec_augment(feats, draws.spec),
        "res8 forward + loss + backward": fwd_bwd,
        "AdamW update": state.optimizer.step,
        "whole step": lambda: noise_step(state, audio, labels, None, SEED),
    }
    _profile(out_dir, "train_profile.txt", f"bf16 noise-bank train step, batch {TRAIN_BATCH} x {TRAIN_WINDOW}", stages,
             lambda: noise_step(state, audio, labels, None, SEED), 5)


def profile_families_live(dev, out_dir, names=("mobilenet", "lstm")) -> None:
    """Stage times and a profile of an ``OnlineEngine`` hop of each family in
    ``names`` at 512 streams, in float32 (K1 at "f32") and in bf16 (K1 at
    "bf16"), on the weights of phase 11c, into
    ``online_<family>_<grade>_profile.txt`` (20 chained hops profiled)."""
    import torch

    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.tools.validate_tpu_decisions import family_audio, family_live_engine, family_live_setup

    cfg, frontend = bench.serving_config(), FrontendConfig(n_mels=N_MELS)
    hop, window = int(cfg.eval_stride_size_ms / 1000 * SAMPLE_RATE), int(cfg.max_window_size_ms / 1000 * SAMPLE_RATE)
    audio = torch.from_numpy(family_audio(ONLINE_STREAMS, window + hop)).to(dev)
    win = audio[:, -window:].contiguous()
    for name in names:
        state, fam_cfg, _ = family_live_setup(name, "full-window", cfg, frontend, dev, audio, True)
        for grade, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            eng = family_live_engine(name, "full-window", state, fam_cfg, frontend, dev, dtype, grade,
                                     num_streams=ONLINE_STREAMS)
            feats = eng._features(win)

            def hops(n=20):
                for _ in range(n):
                    eng._step(win, eng.state, 62.5)

            _profile(out_dir, f"online_{name}_{grade}_profile.txt",
                     f"{grade} OnlineEngine hop of {name}, {ONLINE_STREAMS} streams", {
                         "1. K1 on the windows (fm)": lambda: eng._features(win),
                         "2. the model": lambda: eng.model(feats),
                         "whole hop (_step)": lambda: eng._step(win, eng.state, 62.5),
                     }, hops, 1)
            del eng, feats


def profile_serving(dev, out_dir) -> None:
    """Stage times and a profile of the bf16 serving batch, 512 clips of 8 s,
    through the fused-trunk scorer (``out_dir/serve_profile.txt``, 5 batches
    profiled), the same with the int8 trunk (``serve_int8_profile.txt``) and
    the per-window mega-batch scorer (``out_dir/legacy_profile.txt``, 3
    batches)."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.int8_trunk import residual_features_int8
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    rng = np.random.default_rng(SEED + 1)
    frontend = FrontendConfig(n_mels=N_MELS)
    cfg = EngineConfig(inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
                       negative_label=3, num_labels=4, sample_rate=SAMPLE_RATE)
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(rng, 4))
    samples = int(CLIP_SECONDS * SAMPLE_RATE)
    audio = torch.from_numpy(smoke_audio(rng, BATCH, samples)).to(dev)
    eng, legacy = (StreamingEngine(create_model("res8", num_labels=4), state, cfg, frontend, zmuv_mean=-6.0,
                                   zmuv_std=4.0, compute_dtype=torch.bfloat16, fused_trunk=fused,
                                   frontend_precision="bf16", device=dev)
                   for fused in (True, False))
    geom = eng._step_geometry(BATCH, samples)
    lengths = eng._as_lengths(None, BATCH, samples)
    n_win, wf = geom["n_win"], legacy.window_frames

    def gather(feats):  # the per-window scorer's (B * n_windows, 1, F, wf) windows
        idx = (torch.arange(n_win, device=dev) * legacy.stride_frames)[:, None] + torch.arange(wf, device=dev)
        return feats[:, None][:, :, :, idx].permute(0, 3, 1, 2, 4).reshape(-1, 1, N_MELS, wf)

    with torch.no_grad():
        mel = eng._features(audio, "tm")
        stem = res8_stem_cuda(mel, eng._stem_taps, eng.model.pooling)
        probs = eng._score(audio, n_win)
        _profile(out_dir, "serve_profile.txt", f"bf16 serving batch, fused trunk, {BATCH} x {CLIP_SECONDS:g} s", {
            "1. frontend (K1)": lambda: eng._features(audio, "tm"),
            "2. stem (K2)": lambda: res8_stem_cuda(mel, eng._stem_taps, eng.model.pooling),
            "3. residual convs + BN": lambda: eng.model.residual_features(stem),
            "1-4. scoring (_score)": lambda: eng._score(audio, n_win),
            "5. smoothing + FSM alone": lambda: eng._decide(probs, lengths, geom),
            "infer_batch": lambda: eng.infer_batch(audio),
        }, lambda: eng.infer_batch(audio), 5)

        i8 = StreamingEngine(create_model("res8", num_labels=4), state, cfg, frontend, zmuv_mean=-6.0, zmuv_std=4.0,
                             compute_dtype=torch.bfloat16, frontend_precision="bf16", use_int8_trunk=True,
                             int8_calibration_audio=audio[: bench.CALIBRATION_CLIPS], device=dev)
        _profile(out_dir, "serve_int8_profile.txt", f"bf16 serving batch, fused trunk, int8 trunk, {BATCH} x "
                 f"{CLIP_SECONDS:g} s", {
                     "1. frontend (K1)": lambda: i8._features(audio, "tm"),
                     "2. stem (K2)": lambda: res8_stem_cuda(mel, i8._stem_taps, i8.model.pooling),
                     "3. int8 residual trunk (one fused launch)": lambda: residual_features_int8(stem, i8._int8_params,
                                                                                             torch.bfloat16),
                     "1-4. scoring (_score)": lambda: i8._score(audio, n_win),
                     "5. smoothing + FSM alone": lambda: i8._decide(probs, lengths, geom),
                     "infer_batch": lambda: i8.infer_batch(audio),
                 }, lambda: i8.infer_batch(audio), 5)
        del i8

        feats = legacy._features(audio, "fm")
        windows = gather(feats)
        w_mel = windows[:, 0].transpose(-1, -2).contiguous()
        w_stem = res8_stem_cuda(w_mel, legacy._stem_taps, legacy.model.pooling)
        w_trunk = legacy.model.residual_features(w_stem)
        w_probs = legacy._score(audio, n_win)
        _profile(out_dir, "legacy_profile.txt",
                 f"bf16 serving batch, per-window mega-batch, {BATCH} x {CLIP_SECONDS:g} s, {BATCH * n_win} windows", {
                     "1. frontend (K1, fm)": lambda: legacy._features(audio, "fm"),
                     "window gather + flatten": lambda: gather(feats),
                     "time-major copy of the windows": lambda: windows[:, 0].transpose(-1, -2).contiguous(),
                     "2. stem (K2) on the windows": lambda: res8_stem_cuda(w_mel, legacy._stem_taps, legacy.model.pooling),
                     "3. residual convs + BN": lambda: legacy.model.residual_features(w_stem),
                     "4. mean, head, softmax": lambda: torch.softmax(
                         legacy.model.head(w_trunk.mean(dim=(1, 2))).float(), -1).reshape(BATCH, n_win, -1),
                     "1-4. scoring (_score)": lambda: legacy._score(audio, n_win),
                     "5. smoothing + FSM alone": lambda: legacy._decide(w_probs, lengths, geom),
                     "infer_batch": lambda: legacy.infer_batch(audio),
                 }, lambda: legacy.infer_batch(audio), 3)


def profile_online(dev, out_dir) -> None:
    """Stage times and a profile of a hop of each live engine in bf16, the
    bench's configuration: the ``OnlineEngine`` at 512 streams, the
    incremental and the trunk engine (per hop and with ``hop_block`` 3) at
    512 and at 65,536 streams, into ``online_<engine>_<streams>_profile.txt``
    (20 chained hops profiled: the device's busy and idle share)."""
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference.detect import detect_step
    from howl_tpu_torch.ops.frontend import log_mel_spectrogram
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(SEED), 4))
    cfg = bench.serving_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ring = 4  # hops of audio a stream replays
    for n in (ONLINE_STREAMS, BIG_STREAMS):
        with torch.no_grad():
            buf = torch.randn((n, 8000 + ring * 1000), generator=gen, device=dev) * 0.1
            full = bench.online_engine("full_window", dev, state, n)
            win = buf[:, : full.window_samples].contiguous()
            mel = full._features(win)
            stem = res8_stem_cuda(mel.transpose(1, 2).contiguous(), full._stem_taps)
            trunk = full.model.residual_features(stem)
            probs = torch.softmax(full.model.head(trunk.mean(dim=(1, 2))).float(), -1)

            def tail(eng):
                return {
                    "3. residual convs + BN": lambda: eng.model.residual_features(stem),
                    "4. mean, head, softmax": lambda: torch.softmax(eng.model.head(trunk.mean(dim=(1, 2))).float(), -1),
                    "5. detect_step (smoothing + FSM)": lambda: detect_step(eng.state, probs, 62.5, True, cfg,
                                                                            eng.stride_ms),
                }

            if n == ONLINE_STREAMS:
                _profile(out_dir, f"online_full_window_{n}_profile.txt", f"bf16 OnlineEngine hop, {n} streams", {
                    "1. K1 on the windows (fm)": lambda: full._features(win),
                    "2. time-major copy + K2": lambda: res8_stem_cuda(mel.transpose(1, 2).contiguous(), full._stem_taps),
                    **tail(full),
                    "whole hop (_step)": lambda: full._step(win, full.state, 62.5),
                }, bench.hop_chain(full, buf, 20, ring), 1)
            del full, win

            inc = bench.online_engine("incremental", dev, state, n)
            hop_buf = torch.cat([inc.tail, buf[:, : inc.hop_samples]], -1)
            feats = inc.mel_ring[:, None].to(torch.bfloat16)
            _profile(out_dir, f"online_incremental_{n}_profile.txt", f"bf16 IncrementalOnlineEngine hop, {n} streams", {
                "1. log-mel chain on tail + hop (5 frames)": lambda: log_mel_spectrogram(hop_buf, inc._frontend_nc,
                                                                                         "bf16"),
                "2. time-major copy + K2 on the ring's windows": lambda: inc.model.stem_features(feats, inc._stem_taps),
                **tail(inc),
                "whole hop (_step)": lambda: inc._step(buf[:, : inc.hop_samples], inc.tail, inc.mel_ring, inc.state,
                                                       62.5),
            }, bench.hop_chain(inc, buf, 20, ring), 1)
            del inc, hop_buf, feats, mel, stem, trunk

            for hop_block in (1, 3):
                eng = bench.online_engine("trunk", dev, state, n, hop_block=hop_block)
                H, period = eng.hop_block, eng.schedule.period
                new = buf[:, : H * eng.hop_samples]
                consts = eng.schedule.by_phase[1] if H == 1 else eng.block
                slab_frames = eng.schedule.slab_frames if H == 1 else eng.block["slab_frames"]
                slab = eng.mel_cache[:, consts["slab_start"] : consts["slab_start"] + slab_frames][..., None]
                slab = slab.to(torch.bfloat16)
                if H == 1:
                    def hop_fn(eng=eng, new=new):
                        return eng._hop_step(1, new, eng.tail, eng.mel_cache, eng.rings, eng.s6_ring, eng.state, 62.5,
                                             True)
                else:
                    def hop_fn(eng=eng, new=new):
                        return eng._block_step(new, eng.tail, eng.mel_cache, eng.rings, eng.s6_ring, eng.state, 1, 62.5)
                ring_hops = period + 1 if H == 1 else 2
                _profile(out_dir, f"online_trunk{'_blocked' if H > 1 else ''}_{n}_profile.txt",
                         f"bf16 FusedStreamingOnlineEngine, hop_block {H}, {n} streams (times per call of {H} hops)", {
                             "1. log-mel chain on tail + hops": lambda: eng._mels(torch.cat([eng.tail, new], -1),
                                                                                   eng._frontend_nc),
                             "2-3. trunk_stream_step (slab stem by F.conv2d, six layers)":
                                 lambda: eng.model.trunk_stream_step(slab, eng.rings, consts["delta"]),
                             "4-5. head, softmax, detect_step": lambda: eng._decide(
                                 eng.model.head(eng.s6_ring[:, -eng.span :].mean(1)), eng.state, 62.5, True),
                             f"whole call ({H} hops)": hop_fn,
                         }, bench.trunk_chain(eng, buf[:, : ring_hops * H * eng.hop_samples], ring_hops,
                                              max(21 // (period if H == 1 else H), 1)), 1)
                del eng, new, slab
            del buf
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    from howl_tpu_torch.ops import _build
    from howl_tpu_torch.ops.frontend import FrontendConfig

    print(bench.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.kernel_library()
    print(f"built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    device_line = json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    if "--profile-only" in sys.argv[1:]:
        from pathlib import Path

        out_dir = Path(sys.argv[sys.argv.index("--profile-only") + 1])
        profile_serving(dev, out_dir)
        profile_online(dev, out_dir)
        profile_families_live(dev, out_dir)
        profile_train_step(dev, out_dir)
        print(device_line)
        return 0
    print_sass_counts(_build.library_path())
    print(f"cut for the run's time: the main and train paths' own chained timings take {SMOKE_REPEATS} repeats "
          f"(3 before the live engines' phases); the capacity calibration's points {SERVE_CALIBRATION_STEPS} steps "
          f"(16 before phase 17e, 8 before 17f); each family's training {FAMILY_TRAIN_EPOCHS} epochs (30 before 17f); "
          f"the bench's line keeps its 5 and bench.py's sizes")
    laps = [("build", time.perf_counter() - t0)]
    t_lap = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        laps.append((name, now - t_lap))
        t_lap = now

    gen = torch.Generator(device=dev).manual_seed(SEED)
    samples = int(CLIP_SECONDS * SAMPLE_RATE)
    audio = torch.randn((BATCH, samples), generator=gen, device=dev) * 0.1
    cfg = FrontendConfig(n_mels=N_MELS)
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_plain

    ref = log_mel_spectrogram_plain(audio, cfg, precision="f32")
    zmuv = (float(ref.mean()), float(ref.std()))
    del ref
    k1 = check_frontend(audio, cfg, zmuv)
    taps = torch.randn((3, 3, 45), generator=gen, device=dev) / 3.0
    k2 = check_stem(k1.pop("mel"), taps)
    del audio
    k3 = check_noise_mix(dev)
    lap("frontend, stem and mix kernels")
    study = drive_trunk_study(dev)
    lap("trunk-kernel study")
    micro = drive_frontend_study(dev)
    lap("frontend cost study")
    sweep = drive_hbm_sweep(dev)
    lap("bandwidth sweep")
    main_path = drive_main_path(dev, BATCH, CLIP_SECONDS)
    check_tf32_guard(dev)
    legacy_path = drive_legacy_path(dev, BATCH, CLIP_SECONDS)
    k2["max_abs_err_windows"] = legacy_path["k2_windows_max_abs_err"]
    lap("offline scorers")
    int8 = drive_int8_path(dev, BATCH, CLIP_SECONDS)
    lap("int8 headline")
    drive_int8_tools()
    lap("int8 tools")
    check_decision_gate(dev)
    lap("decision gate")
    families = drive_families(dev)
    k1["launches_families"] = {name: rec["launches"] for name, rec in families.items()}
    lap("the zoo's families")
    families_live = drive_families_live(dev)
    k1["launches_families_live"] = {name: rec["launches"] for name, rec in families_live.items()}
    lap("the families live")
    online_path = drive_online_path(dev)
    k1["online_full_window"], k2["online_full_window"] = online_path["k1"], online_path["k2"]
    k2["online_incremental_65536"] = drive_incremental_at_scale(dev)
    check_live_decisions(dev)
    lap("live engines (a)-(c)")
    check_train_step_against_cpu(dev)
    train_path = drive_train_path(dev)
    lap("train path")
    entry = drive_train_entry(dev)
    lap("train entry point")
    families_train = drive_families_train(dev)
    k3["launches_families_train"] = {tag: rec["k3_launches"] for tag, rec in families_train.items()}
    lap("the families trained")
    serving = drive_serving_surface(dev, entry["state_dict"], entry["zmuv"])
    k1["launches_serving"] = {tag: c["k1"] for tag, c in serving["launches"].items()}
    k2["launches_serving"] = {tag: c["k2"] for tag, c in serving["launches"].items()}
    lap("serving surface")
    harness = drive_config_and_harness(dev)
    k1["launches_harness"], k2["launches_harness"] = harness["k1_harness"], harness["k2_harness"]
    k3["launches_trainer"], k3["launches_seed_sweep"] = harness["k3_trainer"], harness["k3_sweep"]
    lap("config-driven trainer and harness")
    gsc = drive_gsc_and_dataset_pipeline(dev)
    k1["launches_stitched_training"], k2["launches_stitched_training"] = gsc["k1_stitched"], gsc["k2_stitched"]
    k3["launches_stitched_training"] = gsc["k3_stitched"]
    k1["launches_gsc"] = k3["launches_gsc"] = 0  # held at 0 by the phase's checks
    k2["launches_gsc"] = {"pretrain_gsc": gsc["k2_gsc"], "sharded_seeds": gsc["k2_gsc_sweep"],
                          "commands_recognition": gsc["k2_protocol"]}
    lap("GSC pretraining and the dataset pipeline")
    scale = drive_exports_and_scaleout(dev, entry["state_dict"], entry["zmuv"])
    k1["launches_demo"] = {"streams_incremental": scale["demo_streams"]["k1"], "client": scale["demo_client"]["k1"]}
    k2["launches_demo"] = {"streams_incremental": scale["demo_streams"]["k2"], "client": scale["demo_client"]["k2"]}
    k1["launches_sharded"] = {kind: rec["k1"] for kind, rec in scale["sharded"].items()}
    k2["launches_sharded"] = {kind: rec["k2"] for kind, rec in scale["sharded"].items()}
    k2["launches_pretrain"] = scale["k2_pretrain"]
    k2["pretrain_32_rows"] = scale["stem_32"]
    lap("exports, pretraining, demo, profiling and scale-out")
    grid = drive_seed_grid(dev)
    for rec, key in ((k1, "k1"), (k2, "k2"), (k3, "k3")):
        rec["launches_seed_grid"] = [counts[key] for counts in grid["shared"]["ranks"]]
    lap("the seed sweep on a (seed, data) grid and F18")
    last_tools = drive_frontend_tiles_and_tools(dev)
    lap("K1's frame tiles and the last root tools")
    check_bench_record(bench.main(["--device", "cuda"]))
    lap("bench (d)")
    print("phase seconds: " + ", ".join(f"{name} {sec:.1f}" for name, sec in laps))
    if "--profile" in sys.argv[1:]:
        from pathlib import Path

        profile_serving(dev, Path(sys.argv[sys.argv.index("--profile") + 1]))
        profile_online(dev, Path(sys.argv[sys.argv.index("--profile") + 1]))
        profile_families_live(dev, Path(sys.argv[sys.argv.index("--profile") + 1]))
        profile_train_step(dev, Path(sys.argv[sys.argv.index("--profile") + 1]))

    kernels = [
        {
            "name": "log_mel_frontend", "route": "cuda", "source": "howl_tpu_torch/csrc/frontend_tc.cu",
            "replaces": "howl_tpu/ops/frontend_pallas.py:119", "launches": main_path["launches"]["k1_tc"], **k1,
        },
        {
            "name": "res8_stem", "route": "cuda", "source": "howl_tpu_torch/csrc/stem_tc.cu",
            "replaces": "howl_tpu/ops/stem_pallas.py:89", "launches": main_path["launches"]["k2_tc"], **k2,
        },
        {
            "name": "int8_residual_trunk_fused", "route": "cuda", "source": "howl_tpu_torch/csrc/int8_trunk_fused.cu",
            "replaces": "howl_tpu/ops/int8_trunk.py:155", **int8["fused"],
        },
        {
            "name": "int8_residual_layer", "route": "cuda", "source": "howl_tpu_torch/csrc/int8_trunk.cu",
            "replaces": "howl_tpu/ops/int8_trunk.py:155", **int8["layer"],
        },
        {
            "name": "noise_bank_mix", "route": "cuda", "source": "howl_tpu_torch/csrc/augment.cu",
            "replaces": "howl_tpu/ops/augment_pallas.py:43", "launches": train_path["k3_launches"], **k3,
        },
        {
            "name": "trunk_proto", "route": "cuda", "source": "howl_tpu_torch/csrc/trunk_proto.cu",
            "replaces": "tools/bench_trunk_kernel_micro.py:242", "launches": study["launches"]["t1"], **study["t1"],
        },
        {
            "name": "stem_fold_proto", "route": "cuda", "source": "howl_tpu_torch/csrc/stem_fold.cu",
            "replaces": "tools/bench_trunk_kernel_micro.py:377", "launches": study["launches"]["t2"], **study["t2"],
        },
        {
            "name": "micro_stream", "route": "cuda", "source": "howl_tpu_torch/csrc/micro_stream.cu",
            "replaces": "tools/bench_pallas_micro.py:84", "launches": micro["launches"]["m1"], **micro["m1"],
        },
        {
            "name": "micro_gemm", "route": "cuda", "source": "howl_tpu_torch/csrc/micro_gemm.cu",
            "replaces": "tools/bench_pallas_micro.py:87", "launches": micro["launches"]["m2"], **micro["m2"],
        },
        {
            "name": "micro_poly", "route": "cuda", "source": "howl_tpu_torch/csrc/micro_poly.cu",
            "replaces": "tools/bench_pallas_micro.py:144", "launches": micro["launches"]["m3"], **micro["m3"],
        },
        *(
            {"name": f"hbm_{key}" if key != "hbm2hbm" else key, "route": "cuda", "source": f"howl_tpu_torch/csrc/{source}",
             "replaces": f"tools/bench_hbm_sweep.py:{line}", "launches": sweep["launches"][key], **sweep[key]}
            for key, source, line in (("auto_read", "hbm_auto_read.cu", 161), ("auto_copy", "hbm_auto_copy.cu", 181),
                                      ("stream_repro", "micro_stream.cu", 204), ("manual_read", "hbm_manual_read.cu", 238),
                                      ("manual_write", "hbm_manual_write.cu", 285), ("manual_copy", "hbm_manual_copy.cu", 333),
                                      ("hbm2hbm", "hbm2hbm.cu", 414))
        ),
        *(
            {"name": f"log_mel_frontend_{route}_tile{tile}", "route": "cuda",
             "source": f"howl_tpu_torch/csrc/{'frontend_tc.cu' if route == 'tc' else 'frontend.cu'}",
             "replaces": "howl_tpu/ops/frontend_pallas.py:119",
             "launches": sum(c.get(f"{route}{tile}", 0) for c in last_tools["launches"].values()),
             "max_abs_err": rec["max_abs_err_bf16"], "ms": rec["ms_bf16"], "plain_ms": k1["plain_ms"],
             "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
             "launches_by_tool": {tool: c.get(f"{route}{tile}", 0) for tool, c in last_tools["launches"].items()},
             **{key: val for key, val in rec.items() if key.startswith(("ms_", "max_abs_err_"))},
             "grades": rec["grades"], "bit_equal_default_tile": rec["bit_equal_default"]}
            for (route, tile), rec in last_tools["tiles"].items()
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    return 0


if __name__ == "__main__":
    sys.exit(train_repeat_main() if sys.argv[1:] == ["--train-repeat"]
             else trace_batch_main() if sys.argv[1:2] == ["--trace-batch"] else main())
