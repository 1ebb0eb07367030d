#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rafiki_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``rafiki_tpu``. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. analysis phase: runs the port's static-analysis suite,
   ``python -m rafiki_torch.analysis --json``, in a subprocess over the
   tree the script runs from, requires exit 0 and no new finding, and
   prints the findings by code and by status (waived, baselined), the
   files scanned and the seconds;
3. builds every kernel of the port from ``rafiki_torch/ops/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and each
   kernel's registers and spills;
4. kernel phase, forward: runs K1 (``flash_fwd.cu``) against its plain
   PyTorch version ``flash_attention_reference`` on the card at the
   flagship shape and at ragged, cross, ``kv_mask``, f32 and small-head
   shapes (f32 also at the int8 ViT shape, at Tq > Tkv causal and at
   D = 30), comparing ``o`` and ``lse`` with the tolerances stated below:
   every bf16 case on both bf16 variants, ``wgmma`` (which
   ``flash_attention`` must pick there) and ``mma_sync`` (forced), f32 on
   ``f32``. It times the two bf16 variants in turns (mma.sync, wgmma,
   wgmma, mma.sync), the plain version and, as a yardstick only,
   ``torch.nn.functional.scaled_dot_product_attention``, and the host's
   cost of one K1 launch of each variant;
5. kernel phase, backward: runs K2 (``flash_bwd_dq.cu``) and K3
   (``flash_bwd_dkv.cu``) against their plain versions at the flagship
   train shape (8, 16, 2048, 2048, 128) and at ragged, cross causal,
   ``kv_mask`` (one example fully padded), head_dim 80 and f32 shapes:
   every bf16 case on both bf16 variants, ``wgmma`` (which the backward
   must pick there) and ``mma_sync`` (forced), f32 on ``f32``; checks
   that two launches of the wgmma variants give bitwise-equal dq, dk and
   dv at the train shape; holds K1's wgmma variant against its plain
   version at the train shape too; and times K2's and K3's two bf16
   variants in turns (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs,
   their plain versions and, as the yardstick, ``torch.autograd.grad`` of
   ``scaled_dot_product_attention`` (dq, dk and dv together, so its time
   covers K2 and K3 at once), and K1's two bf16 variants in turns beside
   ``scaled_dot_product_attention``; and K2's and K3's f32 variants at
   the f32 causal shape (2, 4, 500, 500, 128) as CUDA graphs, in turns
   with ``torch.autograd.grad`` of ``scaled_dot_product_attention`` in
   f32, beside their plain versions and f32 bounds;
6. train phase: trains ``TorchTransformerLM`` at flagship width
   (d_model 2048, 16 heads of 128, 8 layers, seq_len 2048, vocab 32768,
   batch 8, ``remat`` "dots", initialised on the card from the ``seed``
   knob) for 16 steps, two chunks of 8, on a synthetic Markov token
   stream; checks that every logged loss is finite, that the second
   chunk's mean loss is below the first's, and the launches per step
   (K2 and K3 once per layer, K1 twice: the forward and its rerun under
   "dots", every launch of the three on its wgmma variant); prints the
   step time, tokens
   per second, ``chip_util`` and
   peak memory; profiles one step; and holds one step's loss and
   gradients against the same step on ``flash_attention_plain``;
7. serve phase: serves the trained parameters (``dump_parameters()``)
   through ``InferenceWorker`` and the predictor's ``POST /predict`` on
   a local port, checks every score, times a window of some hundreds of
   scored queries sent by several clients at once, checks that the K1
   launch count grew by ``n_layers`` per scored query, all on the wgmma
   variant, and that K2 and K3 never ran, and holds the served scores
   against the same model with
   attention switched to the plain version; then (fault F1) sends a
   query with an id past the vocabulary, which must answer nan without
   launching K1, after which the worker must score a known query exactly
   as before and its model must still generate;
8. generate phase, on the trained parameters: builds the paged-KV
   engine (``make_generator``, the decode step captured as a CUDA graph)
   and checks (1) greedy decoding against the full forward (K1) over the
   same prefix at every step, (2) one prefill per bucket from 32 to 4096
   rows against the same prefill on the plain attention, its last
   logits and every layer's K and V rows (and on K1 reading K/V one row
   late, a planted fault the rows' limit must see), with
   K1's launches (``n_layers`` a prefill, all wgmma; none for a prefix
   hit or a decode step), K1's own output at each bucket's shape against
   its plain version and K1's time there, (5) a sampled request
   giving the same tokens alone and packed with seven others, and (6)
   the decode step's time as a graph replay and eagerly beside its byte
   bound, the graph's result bit for bit the eager step's, and a profile
   of the step; then sends (3) a window of 64 ``POST /generate``
   requests from 8 clients and (4) four requests to a small engine that
   must preempt, checking every NDJSON stream, and prints tokens per
   second, time to first token, inter-token latency, decode steps, live
   lanes a step and prefills skipped; with ``RAFIKI_TPU_SERVING_GENERATE``
   on for the two windows, the registry's ``rafiki_tpu_lm_*`` family must
   count the tokens streamed, one TTFT a request, the scheduler's decode
   dispatches and its preemptions;
9. automl phase, Rafiki's own loop on ``TorchFeedForward``: writes the
   synthetic image set at fashion-MNIST's split sizes and shape (60,000
   train and 10,000 val images of 28×28×1, 10 classes), runs a
   ``RandomAdvisor`` search of 4 trials through ``TrialRunner`` on the
   card with a ``MetaStore`` and ``ParamStore`` under a temporary
   directory, and prints each trial's knobs, steps, seconds, steps/s,
   val accuracy and ``chip_util``, the search's wall time and trials per
   hour, and the device's busy share over one trial (the search's trial
   of the largest batch, run again under ``torch.profiler``); deploys
   the 2 best trials from ``get_best_trials_of_train_job`` through
   ``ParamStore.load`` into 2 ``InferenceWorker``s behind one
   ``PredictorService``, sends 5 ``POST /predict`` requests and a window
   of 256 single-image requests from 8 clients (queries/s, latency
   p50/p90/p99); checks (a) every trial completed above an accuracy
   floor, (b) each served prediction is the mean of the two workers'
   own, (c) the card's probabilities match the CPU plain path's for the
   same parameters, (d) a params file written on the card loads back
   bit for bit, (e) K1, K2 and K3 did not launch in the phase;
10. platform phase, Rafiki's platform driven as a user drives it: a
   ``LocalPlatform`` on its default device (CUDA) with the admin REST
   service, and ``Client`` over HTTP. (a) The quickstart's flow on
   ``TorchFeedForward`` on a freshly made copy of the automl phase's set:
   a developer registers the model, a train job of 4 trials runs through
   the advisor service and a train worker (its trials per hour printed
   beside the automl phase's in-process figure, with each trial's
   seconds), the 2 best trials deploy as one worker serving the bin of
   both (one card), stacked (its registration says ``stacked``; every
   burst one dispatch), 5 checked requests each equal the float64 mean
   of the two members' stacked rows within 1e-6 (each member's stacked
   rows its own ``predict`` within 3.9e-3), and a window of 256
   single-image requests from 8 clients gives queries/s and latency
   percentiles; (b) while (a)'s job serves, a second train job of 2
   trials trains time-sliced on the same card, and every answer to a
   fixed set of 16 images during and after it must equal the answer
   before, bit for bit; (c) ``FlagshipLM``, a ``TorchTransformerLM``
   subclass whose knob space pins the flagship width, uploaded as
   ``model_source``, trains one ``LANGUAGE_MODELING`` trial on a
   synthetic Markov stream (K1, K2 and K3), deploys, and answers 4 queries
   of 2048 ids through ``POST /predict`` exactly as a directly built
   ``TorchTransformerLM`` on the same params file does; K1, K2 and K3
   must have launched, all on wgmma, and none in (a) and (b). The
   front's `front:` lines: (d) the LM's request went through the
   micro-batcher (``GET /inference_jobs/<id>/stats``); (e) a request
   sent with ``X-Trace-Id`` shows its edge, batcher and worker spans in
   the admin's ``GET /trace/<id>``, the admin's and the predictor's
   ``GET /metrics`` parse with the serving families, and the admin's
   stats route is the predictor's ``/stats``;
11. zoo phase, BASELINE configs 2 and 3 on the synthetic set at
   CIFAR-10's split sizes and image shape (50,000 train and 10,000 val
   images of 32×32×3, 10 classes): (a) ``TorchDenseNet`` at DenseNet-121's
   full width trains one epoch (steps/s, images/s, ``chip_util``, peak
   memory; the loss must fall and val accuracy clear 0.5), one captured
   step is timed and profiled, a second pair of models of the same knobs
   trains 10 steps captured and eagerly and must agree bit for bit, the
   card's logits are held against the CPU's on the same parameters, and
   the params file is read back by ``load_parameters``; (b) a search of
   6 DenseNet-121 trials through ``make_advisor`` with no type, which
   must pick ``BayesOptAdvisor`` (the 6th proposal from the fitted GP);
   (c) an ENAS search at ``JaxEnas``'s sizes through ``make_advisor``,
   which must pick ``EnasAdvisor``: 5 search trials on the masked
   supernet, each after the first warm-starting every supernet tensor,
   and a final trial retraining the best architecture from scratch on
   the single path ((b) and (c) train on the set's first 10,240 train
   images and evaluate on its first 2,048 val images); (d) the 2 best
   ENAS trials behind one predictor
   (served = the members' mean, a 256-request window); (e) K1, K2 and K3
   not launched in the phase;
12. ensemble phase, BASELINE config 4 as the reference serves a bin:
   (a) 4 DenseNet-121 members (the zoo phase's trained one and three
   from seeds) in one bin behind ``BusInferenceWorker``, the predictor
   and ``Client``: a window of 256 single-image requests from 8 clients
   with ``RAFIKI_TPU_SERVING_STACKED`` on (every burst one stacked
   dispatch; a fallback burst fails the phase) and one with it off (4
   dispatches a burst), served = the members' stacked float64 mean
   within 1e-6, each member's rows stacked against its own, and one
   burst's device time at buckets 1, 32 and 512 (one stacked replay,
   four per-member replays, the eager per-member forward), profiled at
   512; (c) ``replace_member(2, ...)``: members 0, 1 and 3 bit for bit,
   member 2 the incoming model's rows, no recapture; (b) int8: the
   automl phase's FeedForward trials stacked under
   ``RAFIKI_TPU_SERVING_QUANT=int8`` (``int8_mm`` equal to the int32
   product at every bucket, |Δp| and val accuracy against f32) and
   DenseNet-121 on the generic fallback (argmax agreement and accuracy
   against f32 on 1,024 val images, peak memory); (d) no K1-K3 launch.
   Between (a) and its member rows, the serving front's ``front:``
   lines on the stacked bin's worker: (a) the 256-request window with
   micro-batching on and off (queries/s, p50/p99, batches and queries a
   batch from ``/stats``, the worker's bursts, answers against the
   worker's own rows); (b) a second replica: both take shards, the rows
   they answer sum to one a query, then one replica hung mid-window
   (registered, serving nothing): every request answered, shard
   resubmits and quarantines counted; (c) a front with ``queue_cap`` 64
   and bursts of 64 raw clients of 16 images: 429s with
   ``Retry-After``, no 5xx, ``/stats`` ``rejected`` equal to the
   clients' 429s, and a ``Client.predict`` answered after its retry;
13. zoo2 phase, the rest of the zoo on the zoo phase's synthetic set
   (made once, in the zoo phase) and on sets cut from the Penn Treebank
   WSJ POS split's and UCI Adult's sizes: (a) ``TorchViT`` at the
   reference's widths (d_model 128, 4 heads of 32, patch 4: 65 tokens,
   all 6 blocks, batch 256) one epoch with its step captured as a CUDA
   graph (steps/s, images/s, ``chip_util``, peak memory, a profiled
   captured step; the loss must
   fall; 6 K1, 6 K2 and 6 K3 a step, all wgmma, counted at the eager
   steps and the capture), one step's loss and gradients against the
   same step on ``flash_attention_plain``, and K1, K2 and K3 on the
   model's own q, k, v against their plain versions, timed as CUDA
   graphs beside ``scaled_dot_product_attention`` and its
   ``autograd.grad`` with their bounds (these comparison launches are
   left out of the phase's counts); (b) a search of 4 one-epoch ViT
   trials through ``make_advisor`` with no type (it must pick
   ``BayesOptAdvisor``), the 2 best stacked in one bin behind
   ``BusInferenceWorker``, the predictor and ``Client``: a stacked
   runner's build launches K1 once a block for both members, served =
   the members' float64 mean within 1e-6, a 256-request window, every
   burst stacked, the stacked rows each member's own within one bf16 ulp
   of a probability; (c) int8: the ViT bin under
   ``RAFIKI_TPU_SERVING_QUANT=int8`` (K1 on its f32 variant, each
   block's launch of one stacked forward of 512 images held against
   ``flash_attention_reference``) and the trained CNN, val accuracy
   within 0.02 of f32, max |Δp|, ``int8_conv`` equal to the exact
   convolution at buckets 1-512 for every convolution served, and K1's
   f32 variant at that shape timed as a CUDA graph beside
   ``scaled_dot_product_attention`` in f32 and its f32 bound, and one
   replay of the int8 stacked runner at bucket 512 beside the share of
   it that its f32 K1 launches take (printed, not checked); (d)
   ``TorchCnn`` at 16/16 one epoch at lr 1e-3 (steps/s, ``chip_util``,
   val accuracy at least 0.95, card vs CPU logits, no K1-K3); (e) the
   transformer tagger at full width (d_model 256, 4 heads of 64, 6
   layers, max_len 128, dropout 0.1, batch 64) one epoch (tokens/s, peak
   memory, val token accuracy, 6 of each kernel a step with
   ``kv_mask``), K1-K3 on its own q, k, v with a fully padded row
   against their plain versions, block 0's output and the logits against
   the plain attention, served through ``POST /predict``; (f)
   ``TorchTabMlpClf``, ``TorchTabMlpReg`` and ``TorchPosTagger`` one
   trial each through ``test_model_class`` on the card, served through
   ``POST /predict``, no K1-K3 launch;
14. lifecycle phase, the serving lifecycle on zoo2 (b)'s 4 ViT trials
   (nothing retrained): written as COMPLETED trials into a
   ``LocalPlatform``'s stores (CUDA, admin REST service), with the edge
   cache, confidence tiering (threshold: the median softmax margin of
   the best trial's own rows averaged with those of the trial that
   shares its bin in (d)), attribution, workload records and a
   client header on, the 2 best deployed through the admin service as
   one worker serving a stacked 2-member bin; (a) 64 distinct images
   three times each: the third round from the cache (``/stats`` hits),
   byte for byte the second's, no burst; 16 concurrent copies of one new
   image in one burst (the leader held in the worker until they wait);
   (b) ``POST /inference_jobs/<id>/promote`` replacing the bin's weaker
   member with the third trial while 8 clients send: all 200, no new
   service, no K1 launch or capture during the restack, a repeat misses,
   answers the restacked rows' mean within 1e-6, the new member's rows
   its own ``TorchViT``'s within 3.9e-3; (c) the fourth trial promoted
   additively under ``RAFIKI_TPU_SERVING_PIPELINE=1``: a second worker,
   time-sliced on the card, pipelined, its runner builds on wgmma, its
   answers its trial's own rows bit for bit, beside the first worker's
   auto decision and measured sync round trip; (d) 256 single images
   from 8 clients over the two bins: each answer the best bin's vote or
   both bins' weighted mean within 1e-6, both tier outcomes and saved
   chip-seconds; (e) one workload record a request, the tenants'
   admitted requests and device seconds; (f) the pipelined worker
   drained under load: every request answered, the worker STOPPED. The
   phase must take at most 90 s;
15. tenants phase, BASELINE config 5 through the observability plane: a
   ``LocalPlatform`` on the card with trace tail sampling on
   (``RAFIKI_TPU_TRACE_TAIL_SAMPLE`` 0.25), exemplars on and
   ``RAFIKI_TPU_TRACE_DIR`` set; two users submit together, through
   ``Client``, a ``TorchFeedForward`` job and a ViT job (the reference's
   widths, 6 blocks, batch 256, one epoch) of 4 trials each with
   ``CHIP_COUNT`` 1, on synthetic CIFAR-10-shaped sets, so the second
   runs time-sliced on the first's card. It prints trials/hour, per-job
   seconds, fairness and the jobs' overlap, the ``/status`` ``mfu``
   readings (polled while the trials run) and their sum, the
   ``GET /trial_phases`` body, K1-K3 launches and the trial traces'
   sizes, and checks: every trial COMPLETED, the windows overlap, each
   K1-K3 launch on wgmma, a ViT trial's ``mfu`` in (0, 1] while it runs
   and ``{}`` after, one ``propose``/``train``/``eval``/``persist`` a
   trial, every trial traced or counted skipped for a busy profiler, a
   trace naming K2's and K3's kernels among its device events. Then the
   ViT job's 2 best serve; a window of 8 clients without and one with
   ``POST /inference_jobs/<id>/profile`` (2 s): every request 200, the
   session counted ``start`` and ``stop``, its trace naming K1's kernel,
   p50/p99 of both windows; then 64 requests under ``seed_tail``: one
   verdict line each in ``trace_verdicts.jsonl``, ``GET /trace/<id>``
   with spans for a kept trace and none for a dropped one, every
   exemplar of ``GET /metrics?exemplars=1`` naming a kept trace;
16. processes phase, the node as processes on the one card, every
   Python child started with jax made unimportable (a ``sitecustomize``
   on its ``PYTHONPATH``, which also prints at its exit the child's
   K1-K3 launches and whether it loaded or built each kernel library):
   (a) ``python -m rafiki_torch broker``, the C++ broker built by g++ in
   the child; (b) ``python -m rafiki_torch serve --bus tcp://...`` and,
   through ``Client``, a ViT job of 4 trials at the reference's widths
   (6 blocks, batch 256, one epoch) on the synthetic CIFAR-10-shaped
   set cut to 8,192 + 1,024 images, with ``RAFIKI_TPU_TRACE_DIR`` set;
   (c) ``python -m rafiki_torch join --train-job``: it exits 0 having
   attached 1 worker, every trial COMPLETED, the trials' workers on two
   nodes, a join node's trial trace naming K1's, K2's and K3's wgmma
   kernels; (d) the 2 best trials served by the primary and ``join
   --inference-job`` adding a replica in a third child: 8 single queries
   to each replica over the bus bit for bit alike and within TOL_PROB of
   the members' forward in this process, then 256 single-image requests
   from 8 clients through the predictor (queries/s, p50/p99, shards by
   replica: both took some, the bus's push, pop and push_many p50); (e)
   the broker killed and restarted, empty, on its port while a client
   sends (the nodes re-register every second): 200 again within 60 s;
   (f) a second inference job of the same trials through a
   ``ServicesManager`` on ``ProcessContainerManager``: its worker and
   predictor are ``python -m rafiki_torch.container.services`` children
   answering (d)'s single queries bit for bit, none alive after
   ``destroy_service``. No child outlives the phase; the children load
   the kernels and build none; the phase must take at most 100 s;
17. cluster phase, the fault plane and the cluster serving fabric over
   TCP brokers in this process, with zoo2 (b)'s ViT trials (the
   reference's widths, 6 blocks) served from ``LocalPlatform``s: (a)
   with the fabric off and no fault plan, a deployed bin and its
   frontends register no ``rafiki_tpu_node_*``, ``_bus_relay_*``,
   ``_serving_fabric_*`` or ``_fault_injections_total`` series and
   ``GET /nodes`` answers ``{"enabled": false}``; (b) two frontends of
   the job with an edge cache admitting on first touch, 8 unique images
   sent to each: 16 queries reach the device with the fabric off, 8 with
   it on, with 8 peer hits each bit for bit the scatter's answer; (c) a
   promote through ``Admin`` acknowledged by both frontends, whose next
   queries miss and scatter again, and a direct ``POST
   /cache/invalidate`` gossiped to the other frontend, whose next query
   misses; (d) two node-scoped brokers, peered, a ViT worker popping
   from the second: a scatter from the first node through the relay
   answers as a local scatter, the relay counters reading out +2, in +2,
   fallback +0 once the hops have landed, then a relay push to the
   stopped second broker counts one fallback within the retry budget;
   (e) two ``LocalPlatform`` nodes on one workdir: ``GET /nodes`` lists
   both live, ``/status`` gives ``cluster.nodes_live`` 2, and a node's
   shutdown withdraws its record; (f) the stack armed quietly, a clean
   window, then ``worker.crash:n=1;bus.delay:p=0.02,ms=2`` under 8
   clients against a bin of two replicas, one on each node: every query
   answered, the crash counted once, ``supervise`` respawning the
   replica (its runner builds launching K1 on wgmma) back into the shard
   plan, the seconds from the death to the full plan printed; then
   ``node.kill`` of the secondary node, the bin answering from the
   primary's replica until the secondary's next sweep respawns its own;
   then ``http.error:route=/predict,n=1``, exactly one 503; (g) memory
   bus push+pop operations a second, disarmed against armed with no
   rules (a record, no limit). The phase must take at most 90 s;
18. autoscale phase, the serving control loop on the card, with zoo2
   (b)'s best ViT trial (6 blocks) served from ``LocalPlatform``s built
   through ``NodeConfig``: (a) with the autoscaler off and no SLO rules,
   a deployed bin and its frontend register no ``rafiki_tpu_autoscale_*``
   or ``rafiki_tpu_slo_*`` series, ``GET /autoscale``, ``/slo`` and
   ``/alerts`` answer ``{"enabled": false}`` and ``GET /capacity``'s gate
   is green under the default policy, and a clean window of 8 clients
   sets the latency objective's threshold; (b) the loop armed on a bin
   of one replica (at most 2, up cooldown 1 s, supervise every 0.5 s,
   one job-scoped p99 rule with windows of seconds), 8 clients, then
   ``worker.slow`` at several times the threshold: the alert goes
   pending then firing, ``GET /autoscale`` records ``scale_up`` for
   ``slo_firing``, the second replica's runner builds launch K1 on
   wgmma and it takes shards; (c) the plan disarmed: the alert
   resolves, ``scale_down`` drains the newest replica under load, the
   bin is back to one replica and its chip share released, ``/alerts``
   shows pending, firing, resolved and ``/slo`` the budget spent;
   every query of (b) and (c) answered; (d) 16 clients against the
   frontend's small admission queue draw 429s and the next sweep
   records ``scale_up`` for ``backpressure``; (e) the recorded workload
   replayed over ``FleetModel.from_exposition`` of the bin's live
   device-time histogram under the live knobs, the simulated p99 and
   actions printed beside the live ones (a record, no limit); (f)
   ``python -m rafiki_torch.capacity score --trace ramp`` exits 0, and
   1 under a degraded policy. The phase must take at most 75 s;
19. operator phase, the operator and data surface over HTTP to one
   ``LocalPlatform`` on the card: (a) zoo2's first 8,192 train images
   and its 1,024 val images uploaded as ``.npz`` files with
   ``Client.create_dataset``, listed by ``GET /datasets?task=``, a
   duplicate name refused and a forged Content-Length answered 413; (b)
   a train job of 2 ViT trials at zoo2 (b)'s widths (6 blocks, batch
   256, 2 epochs) names the uploaded paths and trains from the stored
   files, launching K1, K2 and K3 on wgmma, each trial's logs holding
   the ``Training`` plot record and one loss an epoch; (c)
   ``GET /services/<id>/logs`` gives the train worker's and the
   inference worker's tails, another user 403; (d) the best trial
   deployed with ``serving_packed_wire`` off (no ``ndbatch1`` offered,
   no wire series) and then on, the same 64 images answering bit for
   bit equal, each window's queries/s and p99 printed, and one query
   through ``Cache.send_query`` answered as ``/predict`` answers it; (e)
   ``GET /`` serves the dashboard and every request the page makes
   answers non-404; (f) ``chip_utilization`` above 0 while the job ran
   and 0 after. The phase must take at most 60 s;
20. search phase, checkpoint resume and the trial pipeline: ViT trials
   at zoo2 (b)'s widths on 4,096 of the operator phase's images (16
   steps of 256 an epoch). (a) Two uninterrupted 3-epoch runs set the
   card's run-to-run spread; a ``TrialRunner`` trial under
   ``RAFIKI_TPU_CKPT=1`` dies once epoch 1 is logged and checkpointed,
   and its proposal run again logs ``resumed from checkpoint epoch 1``,
   trains only epoch 2, ends within the spread of the first run, and
   its directory goes; (b) an ASHA job (``advisor_type="asha"``,
   max_epochs 1-9, rungs 1, 3, 9) of 15 trials through
   ``LocalPlatform`` reaches the top rung, every promoted trial logging
   its scoped checkpoint's resume and epochs from its last rung's end
   and recording the cumulative budget; the top configuration trained
   again for 9 uninterrupted epochs under ``schedule_total_epochs`` 9
   ends within the spread of its rung chain; no scoped directory is
   left; the epochs trained and recorded printed; (c) a PBT job,
   population 4, one epoch a round, two rounds: every round-2 trial
   warm-starts from a member's scope and records max_epochs 2; (d) both
   jobs ran through the train worker's prefetch and pipelined persist
   tail: each job's median gap from a trial's last epoch to the next
   train start and its persist tail's seconds printed, the advisors'
   books balanced, and a 2-trial worker's close forgets the proposal it
   prefetched; (e) the transformer tagger (d_model 256, 4 heads of 64,
   2 layers, ``kv_mask``): a 1-epoch rung then the 2-epoch rung resumed
   ends within two uninterrupted runs' distance. K1-K3 launch on wgmma
   throughout. The phase must take at most 60 s;
21. data phase, data staging and real data: (a) ``TorchPosTagger`` and
   ``TorchTransformerTagger`` trained on the bundled English corpus
   (``prepare_bundled_pos_corpus``, 679 hand-tagged sentences) through
   ``rafiki_torch.accuracy_parity``'s corpus rows, with the reference's
   knobs (20 and 30 epochs), each val token accuracy against its band
   (0.89, 0.84), the transformer's K1-K3 launches against the count its
   steps and its evaluation give, all wgmma, and K1 and K2 with K3 at its
   launched shape (batch 32 padded to max_len 64, 4 heads of 32,
   ``kv_mask``) against their plain versions, timed beside
   ``scaled_dot_product_attention`` and its ``autograd.grad``; (b) a
   ``TrialRunner`` sub-train job of 4 one-epoch ViT trials at zoo2 (b)'s
   widths on the search phase's 4,096 + 512 images, both residency
   caches cleared first: each cache counts 2 misses and 6 hits, the
   ``stage`` seconds of trial 1 against trials 2-4 and both bytes
   gauges printed; the same 4 trials with
   ``RAFIKI_TPU_DATASET_CACHE_BYTES=0`` and
   ``RAFIKI_TPU_STAGE_CACHE_BYTES=0`` end bit for bit equal, and every
   staged tensor's sha-256 is unchanged after the 8 trials; (c) trial 1
   again with ``RAFIKI_TPU_STAGE_BYTES`` below its set's bytes, on the
   per-chunk path in chunks of 4 steps: bit for bit the staged trial, no
   stage-cache entry; its train call timed in turns with the staged
   path's (staged, per-chunk, per-chunk, staged) and the host seconds of
   its chunks' gathers printed; then at the port's 128-step chunks, on
   the set tiled to 2 chunks, its chunk loads overlapped with the
   device's steps (the port's) against blocking (the first design, kept
   in this script), in turns, all bit for bit the staged train; (d) the flagship LM (the train phase's
   parameters) evaluating 16 windows of 2048 ids twice on the staged
   stream (a stage miss, then a hit) and once on the host path (the
   cache off): each evaluation's windows bit for bit those cut here
   from the stream, the three logits bit for bit equal, and so their
   cross-entropy and accuracy, K1 8 a forward, all wgmma. The phase
   must take at most 60 s;
22. parallel phase, the mesh and intra-trial parallelism: the
   transformer tagger at the widest point of its knob space (d_model
   256, 8 heads of 32, 6 layers, max_len 512, batch 64, vocab 16384,
   dropout 0) on a corpus of 64 sentences of 256-512 tokens, on a mesh
   of 4 entries that all name the one card (``ChipGroup(indices=(0,) *
   4)`` bound to the thread, as a worker binds its group), in the
   parallelism tour's seven modes: dp 4, sp 2 ring, sp 2 all-to-all,
   ``moe_experts`` 4 over ep 2, pp 2, pp 2 × sp 2 and pp 2 × ep 2 (the
   composed modes at 2 microbatches). Each mode against the
   single-device tagger on the same weights: (a) the logits of the
   batch (tolerances below), (b) one AdamW step's loss and parameters,
   (c) 16 one-step epochs through ``train``, the first and last loss,
   K1-K3 launches equal to the count predicted from the mesh (the
   ring's none), all wgmma, (d) its ``dump_parameters`` loaded into a
   single-device tagger giving the same probabilities and tags; then K1
   and K2 with K3 at the Ulysses rank's shape (32, 4, 512, 512, 32) with
   ``kv_mask`` against their plain versions, timed beside
   ``scaled_dot_product_attention`` and its ``autograd.grad``, and one
   dp row's whole Ulysses forward (the re-chunks' copies and K1). It
   prints the mesh's entries and the number of distinct cards (1). The
   phase must take at most 60 s;
23. dp phase, data and tensor parallelism of the other families on a
   mesh of 4 entries that all name the one card, bound to the thread as
   a worker binds its group, each against the single device on the same
   weights and data: (a) the flagship LM at full width (batch 8 over dp
   4) from the train phase's parameters, two steps through ``train``:
   the losses within ``TOL_STEP_LOSS``, the parameters within
   ``TOL_PAR_STEP`` of the update, and K1-K3 launched 2·2·8·4, 2·8·4
   and 2·8·4 times (every rank's forward, its rerun under "dots" and
   its backward), all wgmma; (b) ViT at zoo2 (a)'s widths with
   ``tensor_parallel`` 2 (dp 2 × tp 2): one step, K1-K3 against the
   count from the mesh, the column-parallel layers over 2 tp ranks, the
   probabilities of 256 images on the mesh against one device's; (c)
   DenseNet-121 at dp 4: one step in float32 without TF32, its
   parameters within ``TOL_DP_F32_STEP`` and the running statistics of
   its 120 BatchNorms (normalised by the whole batch's moments) within
   ``TOL_DP_STATS`` of their move, then a 4-step bf16 epoch of
   ``densenet_small`` whose last step replays the graph captured over
   the 4 lockstep ranks; (d) the tables and the BiLSTM at dp 4, one
   epoch each; (e) a
   ``TrainWorker`` given ``ChipGroup(indices=(0,) * 4)`` trains,
   persists and serves a ViT trial, its K1-K3 against the count from
   the mesh, its served answers (an ``InferenceWorker`` on the group)
   against a single-device load of its parameters. It prints each
   part's losses, step seconds and launches. The phase must take at
   most 90 s;
24. prints each phase's seconds, a ``{"kernels": [...]}`` line, in which
   ``library_covers`` names the kernels whose work one library call does,
   ``platform_launches``, ``zoo_launches``, ``ensemble_launches``,
   ``zoo2_launches``, ``lifecycle_launches``, ``tenants_launches``,
   ``processes_launches``, ``cluster_launches``, ``autoscale_launches``,
   ``operator_launches``, ``search_launches``, ``data_launches``,
   ``parallel_launches`` and ``dp_launches`` the platform, zoo,
   ensemble, zoo2, lifecycle, tenants, processes, cluster, autoscale,
   operator, search, data, parallel and dp phases' launches (the
   platform's, zoo2's, lifecycle's, tenants', the processes' children's,
   the cluster, the autoscale, the operator, the search, the data, the
   parallel and the dp phases' counted in ``launches`` too; ``processes_trace_events``
   each kernel's events in the join node's trial trace), K2's and K3's
   ``f32`` their f32 variants' numbers, ``zoo2_shapes`` each kernel's
   numbers at the ViT and tagger shapes, ``data_shape`` at the real
   corpus's tagger shape, ``parallel_shape`` at the Ulysses rank's
   shape and ``zoo2_f32`` K1's
   f32 variant at the int8 ViT shape with its registers and spills, and,
   last, the ``{"ok": true,
   "device": ...}`` line.

Any failed check exits non-zero without the last line.
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

SEED = 0
FLAGSHIP = {"d_model": 2048, "n_layers": 8, "seq_len": 2048,
            "vocab_size": 32768, "batch_size": 8, "learning_rate": 3e-4,
            "train_steps": 100, "quick_train": False}
# Two chunks of steps_per_dispatch = 8 (below the knob's floor of 20, so
# set after validation).
TRAIN_STEPS = 16
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# |kernel - plain| <= atol + rtol * |plain|. bf16: both outputs are f32
# sums taken in another order and rounded to bf16, so they may differ by
# up to two bf16 ulps (2 * 2^-7 relative). f32: summation order only.
# lse is f32 in both dtypes.
TOL_O = {"bfloat16": (1e-3, 1.6e-2), "float32": (1e-5, 1e-5)}
TOL_LSE = (1e-4, 1e-6)
# K2 and K3 against their plain versions: |kernel - plain| <= a·max|plain|
# + rtol·|plain|. Each gradient sums up to T products with p or ds rounded
# to bf16; where the kernel's exp and the plain version's round an
# intermediate to neighbouring bf16 values, a term moves by one bf16 ulp,
# and the output is rounded to bf16 once. f32: summation order only.
TOL_GRAD = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-5, 1e-4)}
# One train step on the kernels against the same step on the plain
# versions, same weights and windows: the loss, and each parameter's
# gradient as relative Frobenius error. The attention outputs and
# gradients differ by bf16 ulps per layer, carried through eight layers
# of a bf16 residual stream.
TOL_STEP_LOSS = 1e-2
TOL_STEP_GRAD = 3e-2
# Served scores against the plain-attention run of the same model: the
# attention outputs differ by bf16 ulps per layer, carried through eight
# layers of a bf16 residual stream, then averaged over the query's tokens.
TOL_SCORE = 2e-2
# The throughput window: single-query requests of 2 to seq_len + 1 ids,
# sent by this many client threads at once.
WINDOW_REQUESTS = 384
WINDOW_CLIENTS = 8
# The generate phase's engine: 8 lanes of 144 page slots (2304 tokens:
# seq_len plus the generation cap) take 1152 pages; a page holds 8
# layers x 16 tokens x 2048 x 2 bytes x (K, V) = 1 MiB.
GEN_ENGINE = {"page_size": 16, "n_pages": 1280, "decode_batch": 8,
              "max_new_cap": 256, "prefix_cache_entries": 16}
# The decode step's logits against the full forward over the same
# prefix, atol and rtol: the reference's own decode tolerance
# (tests/test_lm_generate.py). The greedy token may part from the full
# forward's argmax only where the latter's top-2 gap is below twice the
# atol.
TOL_LOGITS = (0.08, 0.05)
NEAR_TIE = 0.16
# A prefill on K1 against the same prefill on the plain attention. Its
# last logits, absolute: two bf16 ulps at the logits' magnitude (4 to 8
# in the trained flagship); the unembedding rounds each logit to bf16, and
# the attention outputs' ulp differences move a logit by one ulp (0.03125
# at every bucket on the H100). The logits of the trained flagship hardly
# depend on its attention: K1 reading K/V one row late moves them by that
# same ulp. So every layer's K and V rows, which decoding reads, are held
# too: max |diff| over the layer's max |x| within two bf16 ulps (2^-6).
# On the H100 the kernels stay within one ulp (at most 7.7e-3) and the
# planted late read moves the rows by 0.13 to 0.19; both are printed.
TOL_PREFILL = 0.0625
TOL_KV = 2 ** -6
# One prompt for each prefill bucket (32 to 4096 rows).
PREFILL_LENGTHS = (17, 33, 65, 129, 257, 513, 1025, 2100)
# The window of streamed requests.
GEN_REQUESTS = 64
GEN_CLIENTS = 8
# The automl phase: fashion-MNIST's split sizes and image shape, on the
# synthetic set (real fashion-MNIST is not in the repository).
AUTOML_DATA = {"n_train": 60000, "n_val": 10000, "image_shape": (28, 28, 1),
               "n_classes": 10, "name": "fashion_mnist"}
AUTOML_TRIALS = 4
AUTOML_DEPLOY = 2
# Every trial's val accuracy must clear this (chance is 0.1): each of the
# four trials read 1.0000 on the H100 in the first runs of this phase.
AUTOML_MIN_ACC = 0.99
# The card's probabilities against the CPU's for the same parameters:
# both run flax's bf16 Dense (bf16 products of f32 sums, a bf16 bias),
# summed in another order, so a logit may land one bf16 ulp away; one
# ulp of a logit below 4 in magnitude (2^-6) moves a probability by at
# most 0.25 * 2^-6 (tests/test_torch_feedforward.py).
TOL_PROB = 3.9e-3
# A served ensemble prediction against the mean of its workers' own
# predictions: the same f32 values, averaged in f64 by the predictor.
TOL_ENSEMBLE = 1e-6
AUTOML_WINDOW = 256
AUTOML_CLIENTS = 8

# The platform phase: the quickstart's flow through LocalPlatform and
# the Client over HTTP, on the automl phase's set and trial count. The
# two best trials serve as one worker with a two-trial bin (one card).
PLATFORM_DEPLOY = 2
PLATFORM_CHECKED = 5
# (b): the second train job that trains, time-sliced on the same card,
# while (a)'s inference job serves.
SHARED_TRIALS = 2
SHARED_PROBES = 16
# (c): the flagship LM, uploaded as model_source: a subclass whose knob
# space pins the flagship width (the base space would let the advisor
# draw up to 20,000 steps).
LM_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models.lm import TorchTransformerLM


class FlagshipLM(TorchTransformerLM):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchTransformerLM.get_knob_config())
        cfg.update(d_model=FixedKnob(2048), n_layers=FixedKnob(8),
                   seq_len=FixedKnob(2048), vocab_size=FixedKnob(32768),
                   batch_size=FixedKnob(8), train_steps=FixedKnob(16),
                   learning_rate=FixedKnob(3e-4))
        return cfg
"""
LM_QUERIES = 4

# The zoo phase: BASELINE configs 2 (DenseNet-121) and 3 (ENAS) on the
# synthetic set at CIFAR-10's split sizes and image shape (real CIFAR-10
# is not in the repository).
ZOO_DATA = {"n_train": 50000, "n_val": 10000, "image_shape": (32, 32, 3),
            "n_classes": 10, "name": "cifar10"}
# (a) DenseNet-121 at full width (blocks 6/12/24/16, growth 32); one
# epoch of 390 steps, cut from the knob space's 6 to 60 epochs.
DENSENET_KNOBS = {"arch": "densenet_121", "growth_rate": 32,
                  "batch_size": 128, "learning_rate": 0.1,
                  "weight_decay": 1e-4, "max_epochs": 1,
                  "early_stop_epochs": 5, "quick_train": False}
# Images of the loss before and after the epoch (train mode, a copy).
ZOO_LOSS_IMAGES = 512
# The captured step against the eager step: a second model of the same
# knobs on a set of 10 steps (3 eager and 7 replays against 10 eager).
ZOO_GRAPH_SET = 1280
# Val accuracy after the epoch must clear this (chance is 0.1).
ZOO_MIN_ACC = 0.5
ZOO_PROBES = 8
# Card logits against CPU logits on the same parameters: both run bf16
# convolutions with f32 sums in another order through 120 BatchNorms,
# and the logits leave in bf16: one bf16 ulp of a logit below 32 (the
# trained DenseNet-121's reach 26 on the synthetic set).
TOL_ZOO_LOGITS = 0.125
# (b) and (c) train on the set's first 10,240 train images (80 steps an
# epoch at batch 128) and evaluate on its first 2,048 val images, cut
# from 50,000 and 10,000 (to 20,480 train images with the processes
# phase, to 10,240 and 2,048 with the autoscale phase) to keep the whole
# script under 750 s. At 5,120 every ENAS trial stayed at chance.
ZOO_SEARCH_TRAIN = 10240
ZOO_SEARCH_VAL = 2048
# (b) A Bayes search of DenseNet trials: the 6th proposal is the first
# from the fitted GP (n_initial 5).
BAYES_TRIALS = 6
# (c) An ENAS search at JaxEnas's sizes: 5 search trials and 1 final
# (final_train_frac 0.15), cut from what a user would run (7 and 1
# before the autoscale phase).
ENAS_TRIALS = 6
ZOO_DEPLOY = 2

# The ensemble phase: BASELINE config 4 (ensemble serving of top-k
# trained models) as the reference serves a bin: M DenseNet-121 members
# (full width; the zoo phase's trained one and three from seeds) packed
# on one card, through BusInferenceWorker, the predictor and the Client.
ENSEMBLE_MEMBERS = 4
# The bin's trials serve, they do not train: max_epochs takes the knob
# space's least value (the zoo's trained member took one epoch). A bin
# of an uploaded model_source does not stack, in the reference as here:
# each member's load runs the source anew, so the members' classes
# differ.
ENSEMBLE_KNOBS = dict(DENSENET_KNOBS, max_epochs=6)
# Each window's requests (cut from 512 with the autoscale phase, to keep
# the whole script under 750 s).
ENSEMBLE_WINDOW = 256
ENSEMBLE_BUCKETS = (1, 32, 512)
ENSEMBLE_VAL = 1024
# The serving front's backpressure check: a front with this admission
# bound and super-batch, and bursts of this many raw clients, each
# posting FRONT_BATCH images.
FRONT_CAP = 64
FRONT_BATCH = 16
FRONT_BURST = 64
# Stacked rows against a member's own (per-member) rows on the card. A
# vmapped product is another cuBLAS or cuDNN call than the member's own
# (a batched matmul, a grouped convolution), which may sum the same bf16
# products in another order, so a logit may land on a neighbouring bf16
# value. FeedForward and ViT: one ulp of a logit below 4 (as TOL_PROB;
# ViT's six blocks measured 4.53e-5 on the H100).
# DenseNet-121: its 120 bf16 convolutions each round again, and the
# zoo phase holds its logits card against CPU to one ulp of a logit
# below 32 (TOL_ZOO_LOGITS, 0.125), which moves a probability by at most
# 0.5 * 0.125.
TOL_STACKED_FF = TOL_PROB
TOL_STACKED_DENSENET = 0.0625
# int8 serving against f32: val accuracy may move by at most the
# reference's accuracy-delta gate (bench.py --quant-tol, 0.02).
TOL_INT8_ACC = 0.02

ZOO_DENSENET_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchDenseNet


class ZooDenseNet(TorchDenseNet):
    # arch pinned to DenseNet-121 and max_epochs to 1 (cut from 6-60).
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchDenseNet.get_knob_config())
        cfg.update(arch=FixedKnob("densenet_121"), max_epochs=FixedKnob(1))
        return cfg
"""
ZOO_ENAS_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchEnas


class ZooEnas(TorchEnas):
    # The final trial's max_epochs pinned to 1 (cut from 10).
    @classmethod
    def get_knob_config(cls):
        cfg = super().get_knob_config()
        cfg.update(max_epochs=FixedKnob(1))
        return cfg
"""

# The zoo2 phase: the rest of the zoo. ViT and the VGG-style CNN on the
# zoo phase's synthetic CIFAR-10-shaped set (made once: 50,000 + 10,000
# images of 32×32×3); the transformer tagger on a synthetic corpus cut
# from the Penn Treebank WSJ POS split's size; the tabular MLPs on a
# table cut from UCI Adult's.
# (a) ViT at the reference's widths (d_model 128, 4 heads of 32, patch 4:
# 65 tokens), all 6 blocks, batch 256, one epoch (cut from 3-40).
ZOO2_VIT = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 6,
            "batch_size": 256, "learning_rate": 1e-3, "weight_decay": 1e-4,
            "max_epochs": 1, "early_stop_epochs": 0}
ZOO2_VIT_MIN_ACC = 0.5
# (b) A search of 4 one-epoch ViT trials (cut from what a user runs);
# the 2 best serve stacked in one bin.
ZOO2_VIT_TRIALS = 4
ZOO2_DEPLOY = 2
ZOO2_VAL = 1024
ZOO2_VIT_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT


class ZooViT(TorchViT):
    # max_epochs pinned to 1 (cut from 3-40).
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(max_epochs=FixedKnob(1))
        return cfg
"""
# (d) The CNN at full width (16/16), batch 256, one epoch, at lr 1e-3
# in place of the reference's default 3e-3: at 3e-3 the reference's
# JaxCnn and TorchCnn, from the same weights on this set, both blow up in
# the first steps and stall at chance with the same losses
# (tests/cnn_lr_witness.py). The set's classes are templates under noise
# (a working classifier reads them all), so val accuracy must reach
# ZOO2_CNN_MIN_ACC.
ZOO2_CNN = {"width_16ths": 16, "batch_size": 256, "learning_rate": 1e-3,
            "weight_decay": 1e-4, "max_epochs": 1, "early_stop_epochs": 0}
ZOO2_CNN_MIN_ACC = 0.95
# (e) The tagger at the knob space's largest widths: d_model 256, 4 heads
# of 64, 6 layers, max_len 128, dropout 0.1, batch 64, one epoch (cut
# from 3-30). The corpus: 19,110 train sentences (half the WSJ POS
# split's 38,219, cut with the autoscale phase to keep the whole script
# under 750 s) and 5,527 val (the split's), of 3-128 tokens over 20,000
# words and 45 tags.
ZOO2_TAGGER = {"d_model": 256, "n_heads": 4, "n_layers": 6, "max_len": 128,
               "vocab_size": 16384, "batch_size": 64, "dropout": 0.1,
               "learning_rate": 1e-3, "max_epochs": 1}
ZOO2_CORPUS = {"n_train": 19110, "n_val": 5527, "vocab": 20000,
               "n_tags": 45, "max_len": 128}
# Val token accuracy after the epoch must clear ten times chance (1/45):
# 20,000 words hashed into 16,383 rows leave about 70% of the words
# sharing a row with another, which caps what any tagger reads.
ZOO2_TAGGER_MIN_ACC = 0.25
# (f) UCI Adult's 14 features, 8,192 train and 4,096 val rows (cut from
# its 32,561 and 16,281 with the autoscale phase).
ZOO2_TABLE = {"n_train": 8192, "n_val": 4096, "n_features": 14}
ZOO2_TAB_KNOBS = {"hidden": 128, "depth": 2, "learning_rate": 1e-3,
                  "batch_size": 128, "max_epochs": 5, "seed": 0}
ZOO2_POS_KNOBS = {"embed_dim": 64, "hidden": 64, "learning_rate": 1e-2,
                  "batch_size": 64, "max_epochs": 3, "max_len": 64,
                  "vocab_size": 16384, "seed": 0}
# The lifecycle phase: zoo2 (b)'s 4 one-epoch ViT trials (d_model 128, 4
# heads of 32, patch 4, 65 tokens, 6 blocks) behind a LocalPlatform on
# the card, with the edge cache, confidence tiering, attribution and
# workload records on. (a) 64 distinct images three times each and 16
# concurrent copies of one new image; (b) the surgical promote under 8
# clients; (d) 256 single images from 8 clients. The tier threshold is
# the median softmax margin of the best trial's own rows over 256 val
# images (averaged with the trial that shares its bin in (d)), so both
# tier outcomes occur. A shard a drain strands costs one
# gather timeout, cut to 5 s for the phase.
LIFE_CACHE_BYTES = 64 << 20
LIFE_IMAGES = 64
LIFE_COALESCE = 16
LIFE_CLIENTS = 8
LIFE_TIER = 256
LIFE_HEADER = "X-Client"
LIFE_BUCKETS = (1, 2, 4, 8)
LIFE_GATHER_TIMEOUT = 5.0
LIFE_MAX_S = 90.0
# The tenants phase, BASELINE config 5 (concurrent multi-tenant train
# jobs on one card): two users' jobs of 4 trials each, CHIP_COUNT 1,
# submitted together to a LocalPlatform of one card, so the second runs
# time-sliced on the first's: TorchFeedForward (its knob space, the
# random advisor) and ViT at the reference's widths (d_model 128, 4
# heads of 32, patch 4: 65 tokens, 6 blocks, batch 256) one epoch. The
# ViT job trains on the zoo phases' synthetic CIFAR-10-shaped set
# (50,000 + 10,000, made once in zoo2): 195 steps an epoch, so the
# epoch's utilization has a window after the first 128-step chunk,
# which pays the capture. The feed-forward job's set at the same image
# shape is cut to 4,096 + 512 images (its knob space trains 5 epochs
# at batch 32-128: 160-640 steps), since every kernel of a traced trial
# becomes a trace event, of the other tenant's trial too, and a trace's
# stop and write take seconds a 100 MiB. Tail sampling keeps a quarter
# of the fast, clean traces; every trial is traced
# (RAFIKI_TPU_TRACE_DIR) unless the profiler is busy with the other
# tenant's trial. Then the ViT job's 2 best serve from one worker (an
# uploaded model's members load apart, so they do not stack): a window
# of 8 clients without and with a 2 s on-demand profile, then 64
# traced requests.
TENANT_FF_DATA = {"n_train": 4096, "n_val": 512, "image_shape": (32, 32, 3),
                  "n_classes": 10, "name": "cifar10-ff"}
TENANT_TRIALS = 4
TENANT_VIT_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT


class TenantViT(TorchViT):
    # The reference's widths with its 6 blocks at batch 256; one epoch.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(6), batch_size=FixedKnob(256),
                   max_epochs=FixedKnob(1))
        return cfg
"""
TENANT_TAIL_SAMPLE = 0.25
TENANT_POLL_S = 0.05
TENANT_CLIENTS = 8
TENANT_WINDOW_S = 3.0
TENANT_PROFILE_S = 2.0
TENANT_TRACED = 64
TENANT_MAX_S = 150.0
# The processes phase: the node as processes on the one card. A broker
# child (`python -m rafiki_torch broker`, the C++ broker built by g++), a
# primary (`serve --bus tcp://...`) and `join` children: the train one
# takes part of a ViT job of 4 trials at the reference's widths (d_model
# 128, 4 heads of 32, patch 4: 65 tokens, 6 blocks, batch 256, one
# epoch) on the zoo phases' synthetic CIFAR-10-shaped set cut to 8,192
# + 1,024 images (32 steps an epoch), with every trial traced; the
# inference one adds a replica of the 2 best trials' bin, which 8
# clients then load with 256 single-image requests through the
# predictor over the TCP bus. The broker is then killed and restarted
# empty on its port while a client keeps sending, the nodes
# re-registering every second. Last, a second inference job of the same
# trials deploys through a ServicesManager on ProcessContainerManager:
# its worker and predictor are `python -m rafiki_torch.container.services`
# children. A trial's training waits at a gate until both nodes' workers
# hold a trial, so the job splits over the two nodes. Every Python child
# runs with jax and the reference made unimportable (a sitecustomize on
# its PYTHONPATH), and reports its K1-K3 launches, the device memory its
# allocator reserved at most, and whether it loaded or built each
# kernel library when it exits.
PROC_DATA = {"n_train": 8192, "n_val": 1024, "image_shape": (32, 32, 3),
             "n_classes": 10, "name": "cifar10-proc"}
PROC_TRIALS = 4
PROC_DEPLOY = 2
PROC_VIT_SOURCE = """
import os
import time

from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT

GATE = {gate!r}


class ProcViT(TorchViT):
    # The reference's widths with its 6 blocks at batch 256; one epoch.
    # Training waits for the gate file (at most a minute).
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(6), batch_size=FixedKnob(256),
                   max_epochs=FixedKnob(1))
        return cfg

    def train(self, *args, **kwargs):
        deadline = time.monotonic() + 60
        while not os.path.exists(GATE) and time.monotonic() < deadline:
            time.sleep(0.05)
        return super().train(*args, **kwargs)
"""
PROC_SINGLES = 8
PROC_REQUESTS = 256
PROC_CLIENTS = 8
PROC_RECOVER_S = 60.0
PROC_CHILD_S = 120.0
PROC_MAX_S = 100.0
# A child's sitecustomize: jax and the reference raise when imported;
# at exit the child prints (and writes into PROC_REPORT_ENV's directory)
# its K1-K3 launches, its wgmma launches, its allocator's peak reserve
# and how it came by each kernel library.
PROC_REPORT_ENV = "RAFIKI_SMOKE_REPORT_DIR"
PROC_SITE = """import atexit, importlib.abc, json, os, sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'rafiki_tpu'):
            raise ImportError(name + ' is blocked in this process')
        return None


sys.meta_path.insert(0, _Block())


def _report():
    attn = sys.modules.get('rafiki_torch.ops.attention')
    build = sys.modules.get('rafiki_torch.ops._build')
    fns = [getattr(attn, n) for n in ('flash_attention',
           'flash_attention_dq', 'flash_attention_dkv')] if attn else []
    torch = sys.modules.get('torch')
    rec = {'pid': os.getpid(), 'role': (sys.argv[1:2] or [os.environ.get(
               'RAFIKI_TPU_SERVICE_TYPE', '?')])[0],
           'max_reserved_mib': round(torch.cuda.max_memory_reserved() / 2**20)
           if torch is not None and torch.cuda.is_initialized() else 0,
           'launches': [f.launches for f in fns],
           'wgmma': [f.variant_launches['wgmma'] for f in fns],
           'kernels': build.kernel_origins() if build else {},
           'jax': 'jax' in sys.modules}
    print('processes: child ' + json.dumps(rec), flush=True)
    out = os.environ.get('RAFIKI_SMOKE_REPORT_DIR')
    if out:
        with open(os.path.join(out, '%d.json' % os.getpid()), 'w') as f:
            json.dump(rec, f)


atexit.register(_report)
"""
# The cluster phase serves zoo2 (b)'s ViT trials (the reference's
# widths, 6 blocks, one epoch). (b) sends CLUSTER_IMAGES unique images to
# each of two frontends whose edge caches admit on first touch; (f) runs
# CLUSTER_CLIENTS closed-loop clients against a bin of two replicas, a
# clean window of CLUSTER_CLEAN_S, then the crash; (g) times
# CLUSTER_BUS_OPS push+pop pairs on a memory bus each way, twice.
CLUSTER_IMAGES = 8
CLUSTER_CACHE_BYTES = 64 << 20
CLUSTER_PROBE_S = 2.0
CLUSTER_CLIENTS = 8
CLUSTER_CLEAN_S = 2.0
CLUSTER_GATHER_S = 4.0
CLUSTER_CHAOS_PLAN = "worker.crash:n=1;bus.delay:p=0.02,ms=2"
CLUSTER_SEED = 16
CLUSTER_BUS_OPS = 100000
CLUSTER_WAIT_S = 60.0
CLUSTER_MAX_S = 90.0
# The autoscale phase serves zoo2 (b)'s best ViT trial. AUTOSCALE_CLIENTS
# closed-loop clients send single images; after a warm-up of
# AUTOSCALE_WARM_S (the runner's first buckets), a clean window of
# AUTOSCALE_CLEAN_S sets the p99 objective's threshold (the least
# latency bucket bound at least AUTOSCALE_THRESHOLD_X times the clean p99,
# and at least AUTOSCALE_MIN_THRESHOLD_MS), and worker.slow sleeps
# AUTOSCALE_SLOW_X times that threshold before each dispatch. The
# frontend admits AUTOSCALE_QUEUE_CAP queries: more than the clients of
# (b) and (c) can hold, far fewer than AUTOSCALE_BURST_CLIENTS sending
# AUTOSCALE_BURST_IMAGES images a request, which draw 429s in (d). The
# queue's high water is 1.0 (no queue_high scale-up with 8 clients) and
# its low water 0.25.
AUTOSCALE_CLIENTS = 8
AUTOSCALE_BURST_CLIENTS = 16
AUTOSCALE_BURST_IMAGES = 4
AUTOSCALE_WARM_S = 1.0
AUTOSCALE_QUEUE_CAP = 12
AUTOSCALE_CLEAN_S = 2.0
AUTOSCALE_THRESHOLD_X = 3.0
AUTOSCALE_MIN_THRESHOLD_MS = 10.0
AUTOSCALE_SLOW_X = 2
AUTOSCALE_SWEEP_S = 0.5
AUTOSCALE_RULE = ("vit-p99:p99<{ms:g}ms,window=30,fast=2,slow=4,burn=2,"
                  "for=1,resolve=2")
AUTOSCALE_KNOBS = {"autoscale_max_replicas": 2, "autoscale_up_cooldown_s": 1.0,
                   "autoscale_down_cooldown_s": 3.0,
                   "autoscale_queue_high": 1.0, "autoscale_queue_low": 0.25,
                   "autoscale_mfu_floor": 0.0}
AUTOSCALE_DEGRADED = '{"queue_high": 0.98, "max_replicas": 1, ' \
    '"up_cooldown_s": 60}'
AUTOSCALE_SEED = 17
AUTOSCALE_WAIT_S = 30.0
AUTOSCALE_MAX_S = 75.0
# The operator phase: the operator and data surface of one node on the
# card, driven over HTTP as a user of the dashboard or the client does.
# zoo2's image arrays (the zoo phases' synthetic CIFAR-10-shaped set: its
# first OPERATOR_TRAIN train images and zoo2's ZOO2_VAL val images) are
# written as .npz files and uploaded (POST /datasets); a train job of
# OPERATOR_TRIALS ViT trials at zoo2 (b)'s widths (d_model 128, 4 heads
# of 32, patch 4: 65 tokens, 6 blocks, batch 256) trains OPERATOR_EPOCHS
# epochs (32 steps each) from the stored files; the best trial is
# deployed with the packed wire off, then on, each answering the same
# OPERATOR_WINDOW images as single-image requests from one client, in
# order: each request is then a burst of its own at bucket 1 under both
# wires, so the two sets of answers must agree bit for bit.
OPERATOR_TRAIN = 8192
OPERATOR_TRIALS = 2
OPERATOR_EPOCHS = 2
OPERATOR_WINDOW = 64
OPERATOR_WAIT_S = 60.0
OPERATOR_MAX_S = 60.0
OPERATOR_VIT_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT


class OperatorViT(TorchViT):
    # zoo2 (b)'s widths with all 6 blocks at batch 256.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(6), batch_size=FixedKnob(256),
                   max_epochs=FixedKnob({epochs}))
        return cfg
""".format(epochs=OPERATOR_EPOCHS)
WIRE_FAMILIES = ("rafiki_tpu_serving_wire_bytes_total",
                 "rafiki_tpu_serving_host_copies_total")
# The search phase: checkpoint resume and the trial pipeline on the card.
# ViT trials at zoo2 (b)'s widths (d_model 128, 4 heads of 32, patch 4,
# 65 tokens, 6 blocks, batch 256) train on the first SEARCH_TRAIN of the
# operator phase's images (16 steps an epoch) and are scored on
# SEARCH_VAL of zoo2's val images. (a) A trial of SEARCH_EPOCHS epochs
# through a TrialRunner under RAFIKI_TPU_CKPT=1 dies once epoch 1 is
# logged and checkpointed, and its proposal is run again; (b) an ASHA job
# of SEARCH_ASHA_TRIALS trials over max_epochs 1-9 (eta 3: rungs 1, 3,
# 9), enough to reach the top rung; (c) a PBT job, population 4, one
# epoch a round, two rounds; (d) both through LocalPlatform's train
# worker with prefetch and the pipelined persist tail (its defaults),
# and a 2-trial worker of its own whose close must refund the proposal
# it prefetched; (e) the transformer tagger at zoo2 (e)'s widths cut to
# SEARCH_TAGGER_LAYERS layers, on SEARCH_CORPUS sentences of the WSJ
# split's shape (16 steps of 64), a 1-epoch rung then the 2-epoch rung
# resumed.
SEARCH_TRAIN = 4096
SEARCH_VAL = 512
SEARCH_EPOCHS = 3
SEARCH_ASHA_TRIALS = 15
SEARCH_PBT_POPULATION = 4
SEARCH_TAGGER_LAYERS = 2
SEARCH_CORPUS = {"n_train": 1024, "n_val": 256, "vocab": 20000,
                 "n_tags": 45, "max_len": 128}
SEARCH_WAIT_S = 120.0
SEARCH_MAX_S = 60.0
SEARCH_KNOBS = {"learning_rate": 1e-3, "weight_decay": 1e-4}
SEARCH_VIT_SOURCE = """
from rafiki_torch.model import FixedKnob, IntegerKnob
from rafiki_torch.models import TorchViT


class SearchViT(TorchViT):
    # zoo2 (b)'s widths with all 6 blocks at batch 256; the epoch
    # budget 1-9, so that eta 3 gives the rungs 1, 3 and 9.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(6), batch_size=FixedKnob(256),
                   max_epochs=IntegerKnob(1, 9))
        return cfg
"""
# The data phase: data staging and real data. (a) Both taggers on the
# bundled English corpus through rafiki_torch.accuracy_parity's corpus
# rows (its knobs and bands); (b) one TrialRunner sub-train job of
# DATA_TRIALS one-epoch ViT trials at zoo2 (b)'s widths on the search
# phase's SEARCH_TRAIN + SEARCH_VAL images, with both residency caches on
# and then off; (c) one of them on the per-chunk path, in chunks of
# DATA_CHUNK_STEPS steps; (d) the flagship LM's evaluation of a stream
# of at least 16 windows of 2048 ids, staged twice and then unstaged.
DATA_TRIALS = 4
DATA_LRS = (1e-3, 5e-4, 2e-3, 3e-4)
DATA_CHUNK_STEPS = 4
# (c) at the port's own CHUNK_STEPS: a set of this many full chunks.
DATA_BIG_CHUNKS = 2
DATA_LM_VAL = 1 << 16
DATA_MAX_S = 60.0
# The parallel phase: the transformer tagger at the widest point of its
# knob space on a mesh of PAR_ENTRIES entries, each naming the one card,
# in the parallelism tour's seven modes. A corpus of PAR_SENTENCES (one
# batch) sentences of PAR_LENGTHS tokens (every sp shard holds real and
# padded tokens) trains PAR_STEPS one-step epochs in each mode.
PAR_STEPS = 16
PAR_TAGGER = {"d_model": 256, "n_heads": 8, "n_layers": 6, "max_len": 512,
              "batch_size": 64, "vocab_size": 16384, "dropout": 0.0,
              "learning_rate": 1e-2, "max_epochs": PAR_STEPS, "seed": SEED}
PAR_ENTRIES = 4
PAR_MODES = (("dp 4", {}),
             ("sp 2 ring", {"sequence_parallel": 2}),
             ("sp 2 all-to-all", {"sequence_parallel": 2,
                                  "sp_schedule": "alltoall"}),
             ("ep 2 moe 4", {"moe_experts": 4, "expert_parallel": 2}),
             ("pp 2", {"pipeline_parallel": 2, "pp_microbatches": 0}),
             # The composed modes take 2 microbatches of 32 sentences: the
             # auto count (8) quadruples their host-bound schedules.
             ("pp 2 x sp 2", {"pipeline_parallel": 2, "sequence_parallel": 2,
                              "pp_microbatches": 2}),
             ("pp 2 x ep 2", {"pipeline_parallel": 2, "moe_experts": 4,
                              "expert_parallel": 2, "pp_microbatches": 2}))
PAR_SENTENCES = 64
PAR_VAL = 16
PAR_LENGTHS = (256, 512)
PAR_VOCAB = 500
PAR_TAGS = 5
PAR_MAX_S = 60.0
# (a) a mode's bf16 logits against the single-device tagger's on the
# same weights, at every real token: the port's tagger parity (2^-5)
# where a row meets the single device's kernels and products (dp,
# Ulysses, pp); the zoo's kernel-against-plain tolerance (0.125) where
# the ring folds its shards in f32 instead of K1. A MoE mode routes each
# token by an argmax over bf16 router logits, which products of other
# batch shapes round otherwise, so a near tie may pick another expert:
# there the tolerance may fail at up to PAR_FLIP_SHARE of the tokens.
TOL_PAR_LOGITS = 2 ** -5
TOL_PAR_LOGITS_LOOSE = TOL_ZOO_LOGITS
PAR_FLIP_SHARE = 0.01
# (b) one AdamW step from the same parameters: the losses within
# TOL_STEP_LOSS; the updated parameters within TOL_PAR_STEP of the
# single-device update's size (norms over all parameters). AdamW's
# first step is near lr·sign(g): an element whose gradient rounds to
# the other sign moves by 2·lr.
TOL_PAR_STEP = 0.1
# (d) a mode's file in a single-device tagger: the probabilities at every
# real val token within TOL_PAR_PROB of the mode's own, and the same tag
# but where the two best tags' probabilities are within PAR_NEAR_TIE (in
# a MoE mode both may fail at up to PAR_FLIP_SHARE of the tokens).
TOL_PAR_PROB = 2e-2
PAR_NEAR_TIE = 0.02
# K1's o at the zoo's shapes against its plain version, bf16: each p is
# rounded to bf16 before p·v, and where the kernel's exp and the plain
# version's round one p to neighbouring bf16 values the row moves by up
# to 2^-8·|v| (the flagship shapes' TOL_O leaves no room for that when a
# short row's o cancels to near zero); o is rounded once more (TOL_O).
TOL_O_ROW = 2 ** -8
# A block's output on the kernels against the plain attention, bf16: two
# bf16 ulps at the block's largest value.
TOL_BLOCK = 2 ** -6
# The dp phase: data and tensor parallelism of the other families on a
# mesh of DP_ENTRIES entries, each naming the one card, bound to the
# thread as a worker binds its group. (a) The flagship LM at full width
# (the train phase's parameters) takes one step through train on a
# stream of DP_LM_IDS ids, batch 8 over dp 4; (b) ViT at zoo2 (a)'s
# widths (batch 256) with tensor_parallel 2, dp 2 x tp 2, one step on
# DP_VIT_TRAIN images and its probabilities on DP_VIT_VAL; (c)
# DenseNet-121 (batch 128) over dp 4, one step, then an epoch of
# DP_DENSE_STEPS steps captured after WARMUP_STEPS eager ones against the
# same epoch with every step eager; (d) the tables (batch 128) and the
# BiLSTM (batch 64) over dp 4, one epoch each on zoo2 (f)'s shapes cut
# to DP_TABLE and DP_CORPUS; (e) a TrainWorker given the 4-entry group
# trains, persists and serves one ViT trial on DP_TRIAL_TRAIN images,
# its parameters against the same trial trained on one device and on the
# group with every step eager. Each against the single device on the
# same weights and data.
DP_ENTRIES = 4
DP_LM_IDS = 1 << 16
DP_VIT_TRAIN = 256
DP_VIT_VAL = 256
DP_DENSE_STEPS = 6
# (c)'s epoch (3 eager steps, the capture and its first replay, 2 more
# replays) on the smaller preset: DenseNet-121's eager steps over 4
# lockstep threads took 2.8-5.1 s each on the card, host-bound (the
# ranks' Python dispatch meets at each of 120 BatchNorms).
DP_DENSE_CAPTURE = "densenet_small"
DP_TABLE = {"n_train": 1024, "n_val": 512, "n_features": 14}
DP_CORPUS = {"n_train": 1024, "n_val": 256, "vocab": 2000, "n_tags": 12,
             "max_len": 64}
DP_TRIAL_TRAIN = 2048
DP_TRIAL_VAL = 512
DP_MAX_S = 90.0
# (a)'s planted fault: the 4th rank takes the 3rd rank's windows again
# (windows 4-5 twice, 6-7 never), a fault that a sum over the ranks
# cannot see; the step's parameters must then be more than TOL_PAR_STEP
# of the update off, or the tolerance does not separate.
DP_FAULT_BLOCKS = ((0, 2), (2, 4), (4, 6), (4, 6))
# (b), (c), (d) one step or epoch from the same parameters: the losses
# within TOL_STEP_LOSS, the parameters within TOL_PAR_STEP of the
# single device's update (Adam's and SGD's first steps near lr·sign(g):
# an element whose gradient rounds to the other sign moves by 2·lr); a
# rank's products have a quarter of the rows, which cuBLAS and cuDNN
# may sum in another order.
# (c) DenseNet-121's one step runs in float32 with TF32 off: in bf16 its
# gradient at the start is chaotic (one f32 ulp more on every input
# pixel moved the whole model's gradient by 58% on the H100, the BN
# scales' and biases' by up to 70%), which would hide any fault. There
# the parameters must be within TOL_DP_F32_STEP of the single device's
# update (measured 1.2e-2 for the worst tensor's gradient, 1.5e-6 at
# densenet_tiny) and the running statistics of the 120 BatchNorms within
# TOL_DP_STATS of their move (relative norms); a rank normalising by its
# own 32 rows would move them by the ranks' spread.
TOL_DP_F32_STEP = 5e-2
TOL_DP_STATS = 1e-3
# (b), (e) probabilities of the same parameters, on the mesh and on one
# device: the bf16 logits may land a ulp apart (TOL_PAR_PROB). (c), (e)
# the steps captured over the mesh against eager steps or one device's:
# each step's loss within TOL_STEP_LOSS, the parameters (and (c)'s
# running statistics) within TOL_PAR_STEP of their move.
DP_VIT_SOURCE = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchViT


class DpViT(TorchViT):
    # zoo2 (a)'s widths and batch, one epoch.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchViT.get_knob_config())
        cfg.update(depth=FixedKnob(6), batch_size=FixedKnob(256),
                   max_epochs=FixedKnob(1))
        return cfg
"""


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas
    -v`` log: ``{"kernel<head dim>": {"registers": N, "spill_bytes":
    S}}``."""
    out, name, spill = {}, "?", 0
    for line in log.splitlines():
        # The mangled name: <length><kernel name>ILi<head dim>E.
        entry = re.search(r"Compiling entry function '\S*?(?<=\d)"
                          r"(flash_\w+?_kernel)ILi(\d+)E", line)
        if entry:
            name = f"{entry.group(1)}<{entry.group(2)}>"
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            spill = int(spills.group(1)) + int(spills.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name] = {"registers": int(regs.group(1)),
                         "spill_bytes": spill}
    return out


def ptxas_summary(log: str) -> str:
    """``ptxas_kernels`` as ``kernel<head dim>: N registers, S spill
    bytes; ...``."""
    return "; ".join(f"{name}: {k['registers']} registers, "
                     f"{k['spill_bytes']} spill bytes"
                     for name, k in ptxas_kernels(log).items())


def build_warnings(log: str) -> list:
    """The warning lines of an ``nvcc -Xptxas -v`` log, and the C75xx
    lines (printed as info) with which ptxas says it serialised the
    ``wgmma``s."""
    return [line.strip() for line in log.splitlines()
            if "arning" in line or "C75" in line]


def time_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` runs, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n: int, stream=None) -> float:
    """Mean device time of ``fn`` over ``n`` runs captured in one CUDA
    graph: the host's cost of a launch (tens of microseconds through the
    Python wrapper, near K1's own time at the serve shape) stays out.
    Captured as the port captures (``graph_capture``: one capture at a
    time in the process, the garbage collector off meanwhile), on
    ``stream`` if given (an autograd backward runs on its forward's
    stream, so a backward is captured on the stream its forward ran
    on)."""
    from rafiki_torch.torchenv import graph_capture

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(torch, fn, n: int = 200) -> float:
    """The host's cost of one call of ``fn``: wall time of ``n`` calls
    without a synchronise, divided by ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k1_variants(torch, attn, q, k, v, n: int):
    """K1's two bf16 variants on q, k, v (causal), timed in turns
    (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs; returns the mean
    ms of each."""
    fns = {x: (lambda x=x: attn._flash_forward(q, k, v, True, None,
                                               variant=x))
           for x in ("wgmma", "mma_sync")}
    runs = {"wgmma": [], "mma_sync": []}
    for x in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        runs[x].append(graph_ms(torch, fns[x], n))
    return {x: sum(r) / len(r) for x, r in runs.items()}, fns


def causal_pairs(tq, tkv, causal):
    """The (query, key) pairs the mask lets through (end-aligned)."""
    if not causal:
        return tq * tkv
    shift = tkv - tq
    return sum(min(tkv, max(0, r + shift + 1)) for r in range(tq))


def bound(flops, nbytes, esize):
    """(ms, 'bytes' | 'operations'): the least time for this work on the
    card: the larger of the operations over the peak rate of their type
    and the bytes over the memory rate."""
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, tq, tkv, d, causal, esize):
    """K1: two products (2 FLOP a multiply-add) over the unmasked pairs;
    q, k, v read once, o and lse written once."""
    flops = 4.0 * b * h * causal_pairs(tq, tkv, causal) * d
    nbytes = esize * b * h * (2 * tq + 2 * tkv) * d + 4 * b * h * tq
    return bound(flops, nbytes, esize)


def backward_bounds(b, h, tq, tkv, d, causal, esize):
    """K2 (three products; writes dq) and K3 (four products; writes dk
    and dv): each reads q, k, v, do, lse and delta once."""
    pairs = causal_pairs(tq, tkv, causal)
    read = esize * b * h * (2 * tq + 2 * tkv) * d + 8 * b * h * tq
    k2 = bound(6.0 * b * h * pairs * d, read + esize * b * h * tq * d, esize)
    k3 = bound(8.0 * b * h * pairs * d, read + 2 * esize * b * h * tkv * d,
               esize)
    return k2, k3


def kernel_phase(torch, attn):
    """K1 against its plain version; returns the flagship numbers."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, H, Tq, Tkv, D, dtype, causal, kv_mask lengths (None = none)
    cases = [
        ("flagship", 1, 16, 2048, 2048, 128, bf16, True, None),
        ("ragged", 2, 4, 1000, 1000, 128, bf16, True, None),
        ("cross causal", 2, 4, 300, 1000, 128, bf16, True, None),
        ("cross", 2, 4, 1000, 300, 64, bf16, False, None),
        ("kv_mask causal", 3, 4, 700, 700, 128, bf16, True, [700, 333, 0]),
        ("kv_mask", 3, 4, 257, 700, 128, bf16, False, [700, 333, 0]),
        ("head_dim 80", 2, 2, 130, 130, 80, bf16, True, None),
        ("f32 causal", 2, 4, 500, 500, 128, f32, True, None),
        ("f32 kv_mask", 3, 2, 257, 300, 48, f32, False, [300, 100, 0]),
        # K1's f32 variant at the int8 ViT shape (in batch), at Tq > Tkv
        # under causal (rows before the first key), and at D = 30, which
        # only 4-byte copies can load.
        ("f32 vit", 64, 4, 65, 65, 32, f32, False, None),
        ("f32 Tq>Tkv", 2, 2, 200, 77, 36, f32, True, None),
        ("f32 D=30", 1, 2, 65, 65, 30, f32, False, None),
    ]
    flagship = None
    for name, b, h, tq, tkv, d, dt, causal, lengths in cases:
        q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
        mask = None
        if lengths is not None:
            mask = (torch.arange(tkv, device="cuda")[None, :]
                    < torch.tensor(lengths, device="cuda")[:, None])
        ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                                kv_mask=mask,
                                                return_lse=True)
        auto = "wgmma" if dt == bf16 else "f32"
        check(attn.flash_forward_variant(q, k, v) == auto,
              f"K1 would take {attn.flash_forward_variant(q, k, v)} for "
              f"{name}, not {auto}")
        for variant in ((auto, "mma_sync") if dt == bf16 else (auto,)):
            total = attn.flash_attention.launches
            count = attn.flash_attention.variant_launches[variant]
            if variant == auto:
                o, lse = attn.flash_attention(q, k, v, causal=causal,
                                              kv_mask=mask, return_lse=True)
            else:
                o, lse = attn._flash_forward(q, k, v, causal, mask,
                                             variant=variant)
            torch.cuda.synchronize()
            check(attn.flash_attention.launches == total + 1
                  and attn.flash_attention.variant_launches[variant]
                  == count + 1, f"K1 {variant} did not launch ({name})")
            err_o = (o.float() - ro.float()).abs()
            err_l = (lse - rl).abs()
            atol, rtol = TOL_O[str(dt).split(".")[1]]
            ok_o = bool((err_o <= atol + rtol * ro.float().abs()).all())
            ok_l = bool((err_l <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all())
            print(f"kernel K1 {variant:8s} {name:15s} ({b},{h},{tq},{tkv},"
                  f"{d}) {str(dt)[6:]:8s} causal={causal!s:5s} "
                  f"mask={lengths is not None!s:5s} "
                  f"max|do|={err_o.max().item():.3e} "
                  f"max|dlse|={err_l.max().item():.3e} "
                  f"{'ok' if ok_o and ok_l else 'MISMATCH'}", flush=True)
            check(ok_o and ok_l,
                  f"K1 {variant} disagrees with its plain version ({name})")
            check(bool(torch.isfinite(o.float()).all()),
                  f"K1 {variant} non-finite ({name})")
            if name == "flagship" and variant == "wgmma":
                flagship = (q, k, v, float(err_o.max()))

    q, k, v, err = flagship
    b, h, t, d = q.shape
    ms, fns = k1_variants(torch, attn, q, k, v, 50)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True), 5)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 50)
    host = {x: host_us(torch, fn) for x, fn in fns.items()}
    bound_ms, bound_by = attention_bound(b, h, t, t, d, True, 2)
    tf = {x: 4.0 * b * h * (t * (t + 1) / 2) * d / (m * 1e-3) / 1e12
          for x, m in ms.items()}
    print(f"kernel K1 flagship (1,16,2048,2048,128) bf16 causal, CUDA-graph "
          f"device time: wgmma {ms['wgmma']:.4f} ms ({tf['wgmma']:.1f} "
          f"TFLOP/s), mma.sync {ms['mma_sync']:.4f} ms "
          f"({tf['mma_sync']:.1f} TFLOP/s) (in turns: mma.sync, wgmma, "
          f"wgmma, mma.sync), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; 989 TFLOP/s bf16, 3.35 TB/s); "
          f"host cost of one launch through the wrapper: wgmma "
          f"{host['wgmma']:.1f} us, mma.sync {host['mma_sync']:.1f} us",
          flush=True)
    check(ms["wgmma"] < ms["mma_sync"],
          "K1's wgmma variant is not faster than mma.sync (serve shape)")
    return {"max_abs_err": err, "ms": ms["wgmma"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_covers": ["flash_fwd (K1)"],
            "variant": "wgmma", "mma_sync_ms": ms["mma_sync"],
            "host_us": host["wgmma"], "mma_sync_host_us": host["mma_sync"]}


# K2 and K3: the public wrapper (the variant the shape picks) and the
# private one that forces a variant.
BWD = {"K2": ("flash_attention_dq", "_flash_dq"),
       "K3": ("flash_attention_dkv", "_flash_dkv")}


def bwd(torch, attn, kernel, variant, args, causal, mask):
    """K2 or K3 on ``variant``: through the public wrapper where the shape
    picks that variant, forced otherwise; checks that the launch went to
    it."""
    public, forced = (getattr(attn, x) for x in BWD[kernel])
    total, count = public.launches, public.variant_launches[variant]
    if attn.flash_backward_variant(*args[:4]) == variant:
        out = public(*args, causal=causal, kv_mask=mask)
    else:
        out = forced(*args, causal, mask, variant=variant)
    torch.cuda.synchronize()
    check(public.launches == total + 1
          and public.variant_launches[variant] == count + 1,
          f"{kernel} {variant} did not launch")
    return out


def bwd_variants(torch, attn, args, n: int):
    """K2's and K3's two bf16 variants on ``args`` (causal), timed in
    turns (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs; returns the
    mean ms of each (kernel, variant)."""
    fns = {(kern, x): (lambda f=getattr(attn, BWD[kern][1]), x=x:
                       f(*args, True, None, variant=x))
           for kern in BWD for x in ("wgmma", "mma_sync")}
    runs = {key: [] for key in fns}
    for x in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        for kern in BWD:
            runs[kern, x].append(graph_ms(torch, fns[kern, x], n))
    return {key: sum(r) / len(r) for key, r in runs.items()}


def bwd_f32_times(torch, attn, args, errs):
    """K2's and K3's f32 variants at one f32 causal shape as CUDA graphs,
    in turns with ``torch.autograd.grad`` of
    ``scaled_dot_product_attention`` in f32 (kernels, library, library,
    kernels), beside their plain versions and their bounds at 4 bytes an
    element and the f32 peak."""
    import torch.nn.functional as F

    q, k, v, do, lse, delta = args
    b, h, t, d = q.shape
    fns = {"K2": lambda: attn._flash_dq(q, k, v, do, lse, delta, True,
                                         None, variant="f32"),
           "K3": lambda: attn._flash_dkv(q, k, v, do, lse, delta, True,
                                          None, variant="f32")}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    runs = {key: [] for key in ("K2", "K3", "lib")}
    for turn in ("kernels", "lib", "lib", "kernels"):
        if turn == "lib":
            runs["lib"].append(time_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), 20))
        else:
            for key in ("K2", "K3"):
                runs[key].append(graph_ms(torch, fns[key], 20))
    plain = {"K2": time_ms(torch, lambda: attn.flash_attention_dq_reference(
                 *args, causal=True), 3),
             "K3": time_ms(torch, lambda: attn.flash_attention_dkv_reference(
                 *args, causal=True), 3)}
    bounds = dict(zip(("K2", "K3"), backward_bounds(b, h, t, t, d, True, 4)))
    lib = sum(runs["lib"]) / 2
    rows = {key: {"ms": sum(runs[key]) / 2, "plain_ms": plain[key],
                  "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                  "max_abs_err": (errs["dq"] if key == "K2"
                                  else max(errs["dk"], errs["dv"]))}
            for key in ("K2", "K3")}
    print(f"kernel K2/K3 f32 ({b},{h},{t},{t},{d}) causal, CUDA-graph device "
          f"time (in turns with the library): K2 {rows['K2']['ms']:.4f} ms "
          f"(bound {rows['K2']['bound_ms']:.4f} ms, "
          f"{rows['K2']['bound_by']}; plain {plain['K2']:.4f} ms); K3 "
          f"{rows['K3']['ms']:.4f} ms (bound {rows['K3']['bound_ms']:.4f} "
          f"ms, {rows['K3']['bound_by']}; plain {plain['K3']:.4f} ms); "
          f"K2 + K3 {rows['K2']['ms'] + rows['K3']['ms']:.4f} ms against "
          f"autograd.grad of scaled_dot_product_attention in f32 (dq, dk, "
          f"dv) {lib:.4f} ms ({PEAK_F32_FLOPS:.3g} FLOP/s f32, 3.35 TB/s)",
          flush=True)
    return {"K2": rows["K2"], "K3": rows["K3"], "library_ms": lib,
            "shape": [b, h, t, t, d]}


def backward_phase(torch, attn):
    """K2 and K3 against their plain versions; returns the numbers of
    both at the flagship train shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, H, Tq, Tkv, D, dtype, causal, kv_mask lengths (None = none)
    cases = [
        ("flagship train", 8, 16, 2048, 2048, 128, bf16, True, None),
        ("ragged", 2, 4, 1000, 1000, 128, bf16, True, None),
        ("cross causal", 2, 4, 300, 1000, 128, bf16, True, None),
        ("kv_mask causal", 3, 4, 700, 700, 128, bf16, True, [700, 333, 0]),
        ("head_dim 80", 2, 2, 130, 130, 80, bf16, True, None),
        ("f32 causal", 2, 4, 500, 500, 128, f32, True, None),
        ("f32 kv_mask", 3, 2, 257, 300, 48, f32, False, [300, 100, 0]),
    ]
    flagship = None
    for name, b, h, tq, tkv, d, dt, causal, lengths in cases:
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
                for _ in range(2))
        mask = None
        if lengths is not None:
            mask = (torch.arange(tkv, device="cuda")[None, :]
                    < torch.tensor(lengths, device="cuda")[:, None])
        o, lse = attn.flash_attention_reference(q, k, v, causal=causal,
                                                kv_mask=mask, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        kw = dict(causal=causal, kv_mask=mask)
        rq = attn.flash_attention_dq_reference(*args, **kw)
        rk, rv = attn.flash_attention_dkv_reference(*args, **kw)
        auto = "wgmma" if dt == bf16 else "f32"
        check(attn.flash_backward_variant(q, k, v, do) == auto,
              f"K2/K3 would take {attn.flash_backward_variant(q, k, v, do)} "
              f"for {name}, not {auto}")
        a, rtol = TOL_GRAD[str(dt).split(".")[1]]
        errs = {}
        for variant in ((auto, "mma_sync") if dt == bf16 else (auto,)):
            dq = bwd(torch, attn, "K2", variant, args, causal, mask)
            dk, dv = bwd(torch, attn, "K3", variant, args, causal, mask)
            errs[variant] = {}
            for what, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                                   ("dv", dv, rv)):
                err = (got.float() - ref.float()).abs()
                ok = bool((err <= a * ref.float().abs().max()
                           + rtol * ref.float().abs()).all())
                errs[variant][what] = float(err.max())
                check(bool(torch.isfinite(got.float()).all()),
                      f"{variant} {what} non-finite ({name})")
                check(ok, f"{'K2' if what == 'dq' else 'K3'} {variant} {what} "
                      f"disagrees with its plain version ({name})")
            e = errs[variant]
            print(f"kernel K2/K3 {variant:8s} {name:15s} ({b},{h},{tq},{tkv},"
                  f"{d}) {str(dt)[6:]:8s} causal={causal!s:5s} "
                  f"mask={lengths is not None!s:5s} max|ddq|={e['dq']:.3e} "
                  f"max|ddk|={e['dk']:.3e} max|ddv|={e['dv']:.3e} "
                  f"(max|dq|={rq.float().abs().max().item():.3e}) ok",
                  flush=True)
            if name == "flagship train" and variant == "wgmma":
                # Each block writes its rows once, without atomics: a
                # second launch gives the same bits.
                dq2 = bwd(torch, attn, "K2", variant, args, causal, mask)
                dk2, dv2 = bwd(torch, attn, "K3", variant, args, causal, mask)
                same = all(bool(torch.equal(x, y)) for x, y in
                           ((dq, dq2), (dk, dk2), (dv, dv2)))
                print(f"kernel K2/K3 wgmma flagship train: a second launch "
                      f"gives bitwise-equal dq, dk, dv: {same}", flush=True)
                check(same, "K2/K3 wgmma differ from run to run")
                del dq2, dk2, dv2
        if name == "flagship train":
            # K1 at the shape every train step gives it, against the
            # plain o and lse computed above.
            wg = attn.flash_attention.variant_launches["wgmma"]
            ko, kl = attn.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
            torch.cuda.synchronize()
            check(attn.flash_attention.variant_launches["wgmma"] == wg + 1,
                  "K1 did not take the wgmma variant at the train shape")
            err_o = (ko.float() - o.float()).abs()
            err_l = (kl - lse).abs()
            atol, rtol = TOL_O["bfloat16"]
            check(bool((err_o <= atol + rtol * o.float().abs()).all())
                  and bool((err_l <= TOL_LSE[0]
                            + TOL_LSE[1] * lse.abs()).all()),
                  "K1 disagrees with its plain version (flagship train)")
            k1_errs = (float(err_o.max()), float(err_l.max()))
            del ko, kl, err_o, err_l
            flagship = (args, errs)
        if name == "f32 causal":
            f32_case = (args, errs["f32"])
        del dq, dk, dv, rq, rk, rv
    f32_rows = bwd_f32_times(torch, attn, *f32_case)

    (q, k, v, do, lse, delta), errs = flagship
    b, h, t, d = q.shape
    ms = bwd_variants(torch, attn, (q, k, v, do, lse, delta), 20)
    plain_q = time_ms(torch, lambda: attn.flash_attention_dq_reference(
        q, k, v, do, lse, delta, causal=True), 3)
    plain_kv = time_ms(torch, lambda: attn.flash_attention_dkv_reference(
        q, k, v, do, lse, delta, causal=True), 3)
    k1_ms, _ = k1_variants(torch, attn, q, k, v, 20)
    plain_fwd = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True), 3)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 20)
    lib_fwd_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    (b2_ms, b2_by), (b3_ms, b3_by) = backward_bounds(b, h, t, t, d, True, 2)
    b1_ms, _ = attention_bound(b, h, t, t, d, True, 2)
    pairs = causal_pairs(t, t, True)
    tf = lambda prods, ms: 2.0 * prods * b * h * pairs * d / (ms * 1e-3) / 1e12
    pair = {x: ms["K2", x] + ms["K3", x] for x in ("wgmma", "mma_sync")}
    print(f"kernel train shape ({b},{h},{t},{t},{d}) bf16 causal, CUDA-graph "
          f"device time (in turns: mma.sync, wgmma, wgmma, mma.sync): "
          f"K2 wgmma {ms['K2', 'wgmma']:.4f} ms "
          f"({tf(3, ms['K2', 'wgmma']):.1f} TFLOP/s), mma.sync "
          f"{ms['K2', 'mma_sync']:.4f} ms ({tf(3, ms['K2', 'mma_sync']):.1f} "
          f"TFLOP/s), bound {b2_ms:.4f} ms, plain {plain_q:.4f} ms; "
          f"K3 wgmma {ms['K3', 'wgmma']:.4f} ms "
          f"({tf(4, ms['K3', 'wgmma']):.1f} TFLOP/s), mma.sync "
          f"{ms['K3', 'mma_sync']:.4f} ms ({tf(4, ms['K3', 'mma_sync']):.1f} "
          f"TFLOP/s), bound {b3_ms:.4f} ms, plain {plain_kv:.4f} ms; "
          f"K2 + K3 wgmma {pair['wgmma']:.4f} ms, mma.sync "
          f"{pair['mma_sync']:.4f} ms, against autograd.grad of "
          f"scaled_dot_product_attention (dq, dk, dv) {lib_ms:.4f} ms "
          f"(wgmma pair / library {pair['wgmma'] / lib_ms:.2f}x); K1 wgmma "
          f"{k1_ms['wgmma']:.4f} ms ({tf(2, k1_ms['wgmma']):.1f} TFLOP/s), "
          f"mma.sync {k1_ms['mma_sync']:.4f} ms "
          f"({tf(2, k1_ms['mma_sync']):.1f} TFLOP/s) (CUDA graphs, in "
          f"turns), bound {b1_ms:.4f} ms, plain {plain_fwd:.4f} ms, "
          f"scaled_dot_product_attention "
          f"{lib_fwd_ms:.4f} ms, wgmma max|do|={k1_errs[0]:.3e} "
          f"max|dlse|={k1_errs[1]:.3e} against its plain version, ok) "
          f"(989 TFLOP/s bf16, 3.35 TB/s)", flush=True)
    check(k1_ms["wgmma"] < k1_ms["mma_sync"],
          "K1's wgmma variant is not faster than mma.sync (train shape)")
    check(pair["wgmma"] < pair["mma_sync"],
          "K2 + K3 on wgmma are not faster than on mma.sync (train shape)")
    # The library call computes dq, dk and dv at once: its time covers
    # K2 and K3 together.
    both = ["flash_bwd_dq (K2)", "flash_bwd_dkv (K3)"]
    k1_train = {"train_ms": k1_ms["wgmma"], "train_bound_ms": b1_ms,
                "train_plain_ms": plain_fwd, "train_library_ms": lib_fwd_ms,
                "train_mma_sync_ms": k1_ms["mma_sync"],
                "train_max_abs_err": k1_errs[0]}
    shared = {"library_ms": lib_ms, "library_covers": both,
              "variant": "wgmma", "pair_ms": pair["wgmma"],
              "pair_mma_sync_ms": pair["mma_sync"],
              "pair_over_library": pair["wgmma"] / lib_ms}
    shared_f32 = {"library_ms": f32_rows["library_ms"],
                  "shape": f32_rows["shape"]}
    return (k1_train,
            {"max_abs_err": errs["wgmma"]["dq"], "ms": ms["K2", "wgmma"],
             "f32": dict(f32_rows["K2"], **shared_f32),
             "plain_ms": plain_q, "bound_ms": b2_ms, "bound_by": b2_by,
             "mma_sync_ms": ms["K2", "mma_sync"],
             "mma_sync_max_abs_err": errs["mma_sync"]["dq"], **shared},
            {"max_abs_err": max(errs["wgmma"]["dk"], errs["wgmma"]["dv"]),
             "ms": ms["K3", "wgmma"], "plain_ms": plain_kv,
             "f32": dict(f32_rows["K3"], **shared_f32),
             "bound_ms": b3_ms, "bound_by": b3_by,
             "mma_sync_ms": ms["K3", "mma_sync"],
             "mma_sync_max_abs_err": max(errs["mma_sync"]["dk"],
                                         errs["mma_sync"]["dv"]), **shared})


KERNEL_FNS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")


def launch_counts(attn):
    """(K1, K2, K3, then each of the three on its wgmma variant)."""
    fns = [getattr(attn, x) for x in KERNEL_FNS]
    return (tuple(f.launches for f in fns)
            + tuple(f.variant_launches["wgmma"] for f in fns))


def reset_launch_counts(attn):
    for fn in (getattr(attn, x) for x in KERNEL_FNS):
        fn.launches = 0
        for variant in fn.variant_launches:
            fn.variant_launches[variant] = 0


class uncounted:
    """A block whose K1-K3 launches are a check's, not the main path's:
    every count is put back on the way out."""

    def __init__(self, attn):
        self.fns = [getattr(attn, x) for x in KERNEL_FNS]

    def __enter__(self):
        self.saved = [(f.launches, dict(f.variant_launches))
                      for f in self.fns]

    def __exit__(self, *exc):
        for f, (n, by) in zip(self.fns, self.saved):
            f.launches = n
            f.variant_launches.update(by)


def step_grads(model, win):
    """One step's loss and f32 gradients, by parameter name."""
    model._net.zero_grad(set_to_none=True)
    loss, _ = model._loss(win)
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in model._net.named_parameters()}
    model._net.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def train_phase(torch, np, attn, card):
    """Trains the flagship LM on the kernels; returns its dumped
    parameters and the K1, K2 and K3 launches of the training run."""
    import tempfile

    from rafiki_torch.datasets import make_synthetic_token_dataset
    from rafiki_torch.model.dataset import load_token_dataset
    from rafiki_torch.model.logger import logger
    from rafiki_torch.model.loop_ckpt import epoch_rng
    from rafiki_torch.model.optim import adamw
    from rafiki_torch.models import TorchTransformerLM

    knobs = dict(TorchTransformerLM.validate_knobs(FLAGSHIP),
                 train_steps=TRAIN_STEPS)
    L, b, t = knobs["n_layers"], knobs["batch_size"], knobs["seq_len"]
    k_disp = knobs["steps_per_dispatch"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_path, _ = make_synthetic_token_dataset(
            tmp, n_train=1 << 20, n_val=1 << 12,
            vocab_size=knobs["vocab_size"], seed=SEED)
        ds = load_token_dataset(train_path)
        print(f"train: synthetic Markov stream of {ds.size} ids, vocab "
              f"{ds.vocab_size}, made in {time.perf_counter() - t0:.1f} s",
              flush=True)
        model = TorchTransformerLM(device="cuda", **knobs)
        records = []

        def sink(rec):
            if rec.get("type") == "values":
                records.append((time.perf_counter(), rec["values"]))

        prev = logger.current_sink()
        logger.set_sink(sink)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(attn)
        t0 = time.perf_counter()
        try:
            model.train(train_path)
        finally:
            logger.set_sink(prev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts(attn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [r["loss"] for _, r in records]
    steps = [r["step"] for _, r in records]
    print(f"train: {TRAIN_STEPS} steps in {secs:.2f} s (first use "
          f"included); chunk records " + "; ".join(
              f"step {r['step']} loss {r['loss']:.4f} token_acc "
              f"{r['token_acc']:.5f}" + (f" chip_util {r['chip_util']}"
                                         if "chip_util" in r else "")
              for _, r in records), flush=True)
    check(steps == list(range(k_disp, TRAIN_STEPS + 1, k_disp)),
          f"logged steps {steps}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"the chunk loss did not fall: {losses}")
    per_step = [n / TRAIN_STEPS for n in launches]
    print(f"train: launches per step K1 {per_step[0]:g} (wgmma "
          f"{per_step[3]:g}), K2 {per_step[1]:g} (wgmma {per_step[4]:g}), K3 "
          f"{per_step[2]:g} (wgmma {per_step[5]:g}) ({L} layers, remat "
          f"{knobs['remat']!r})", flush=True)
    check(per_step == [2 * L, L, L, 2 * L, L, L],
          f"launches per step {per_step}: expected K1 {2 * L} (the forward "
          f"and its rerun under 'dots'), K2 {L}, K3 {L}, all on wgmma")
    chunk_secs = records[1][0] - records[0][0]
    step_ms = chunk_secs / k_disp * 1e3
    util = records[1][1].get("chip_util")
    check(util is not None and 0 < util < 1, f"chip_util {util}")
    print(f"train: steady chunk of {k_disp} steps in {chunk_secs:.3f} s = "
          f"{step_ms:.1f} ms a step, {b * t / (step_ms * 1e-3):.1f} tokens/s, "
          f"chip_util {util} (analytic {model._flops_per_step(b) / 1e12:.2f} "
          f"TFLOP a step over 989 TFLOP/s bf16); peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated) on {card}", flush=True)

    params = model.dump_parameters()
    # Checks after the run: the same windows for every step below.
    rng = epoch_rng(SEED, 1)
    starts = rng.integers(0, ds.size - (t + 1), size=b)
    win = torch.from_numpy(np.stack([ds.ids[i:i + t + 1] for i in starts])
                           .astype(np.int64)).to("cuda")
    opt = adamw(model._net.parameters(), 0.0)  # lr 0: weights stay put

    def one_step():
        model._net.zero_grad(set_to_none=True)
        loss, _ = model._loss(win)
        loss.backward()
        opt.step()

    profile(torch, one_step, f"one train step (batch {b} x {t})", card, 18)
    loss_k, grads_k = step_grads(model, win)
    model.attention = attn.flash_attention_plain
    loss_p, grads_p = step_grads(model, win)
    model.attention = attn.flash_attention
    errs = {n: float((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm())
            for n in grads_p}
    worst = max(errs, key=errs.get)
    print(f"train: one step on the kernels vs flash_attention_plain, same "
          f"weights and windows: loss {loss_k:.6f} vs {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3e}, tolerance {TOL_STEP_LOSS}); gradient "
          f"relative error max {errs[worst]:.3e} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)} "
          f"parameters (tolerance {TOL_STEP_GRAD})", flush=True)
    check(abs(loss_k - loss_p) <= TOL_STEP_LOSS,
          "the step's loss disagrees with the plain-attention step")
    check(errs[worst] <= TOL_STEP_GRAD,
          "a gradient disagrees with the plain-attention step")
    model.destroy()
    del opt, grads_k, grads_p
    torch.cuda.empty_cache()
    return params, launches


def post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0


def profile(torch, fn, what, card, top=10):
    """Where the time of one ``fn()`` goes on the card: device time by
    kernel, and the device's busy share of the wall time. Returns the
    rows, (device us, count, kernel name), and the busy us; None when
    the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from rafiki_torch.observe.profiling import PROFILER_LOCK

    fn()
    torch.cuda.synchronize()
    # One profiler a process: the port's trial traces and on-demand
    # sessions take the same lock.
    with PROFILER_LOCK, torch_profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side kernel rows only: the host operators' rows repeat the
    # device time of the kernels they launch, and a user annotation's row
    # (the optimizer's step range) spans kernels already counted.
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: the profiler recorded no device time: not measured",
              flush=True)
        return None
    print(f"profile: {what}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%) on {card}",
          flush=True)
    for us, n, key in sorted(rows, reverse=True)[:top]:
        print(f"profile: {100 * us / busy:5.1f}% {us / 1e3:8.3f} ms "
              f"x{n:<4d} {key[:90]}", flush=True)
    return rows, busy


def throughput_window(np, url, ids, seq_len, card, n_requests=WINDOW_REQUESTS,
                      clients=WINDOW_CLIENTS) -> int:
    """The scoring service's rate: ``n_requests`` single-query requests
    of random lengths, sent by ``clients`` threads at once. Checks each
    answer and prints latency percentiles and tokens scored per second;
    returns the number of queries scored."""
    from concurrent.futures import ThreadPoolExecutor

    lengths = np.random.default_rng(SEED + 2).integers(
        2, seq_len + 2, size=n_requests).tolist()
    queries = [ids(n) for n in lengths]

    def one(q):
        status, body, dt = post(url + "/predict", {"query": q})
        check(status == 200, f"/predict answered {status}")
        p = body["prediction"]
        check(isinstance(p, float) and math.isfinite(p),
              f"non-finite score {p}")
        return dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        lat = sorted(pool.map(one, queries))
    secs = time.perf_counter() - t0
    n_tok = sum(min(n, seq_len + 1) - 1 for n in lengths)
    pct = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3
           for p in (50, 90, 99)}
    print(f"slice: window of {n_requests} single-query requests from "
          f"{clients} clients: {n_tok} tokens scored in {secs:.4f} s = "
          f"{n_tok / secs:.1f} tokens/s, {n_requests / secs:.2f} queries/s; "
          f"latency p50 {pct[50]:.2f} ms, p90 {pct[90]:.2f} ms, p99 "
          f"{pct[99]:.2f} ms (one padded {seq_len}-position forward per "
          f"query) on {card}", flush=True)
    return n_requests


def slice_phase(torch, np, attn, card, params):
    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.torchenv import sync
    from rafiki_torch.worker import InferenceWorker

    knobs = FLAGSHIP
    t0 = time.perf_counter()
    n_params = sum(a.size for a in params.values())
    worker = InferenceWorker(TorchTransformerLM, knobs, params,
                             device="cuda")
    sync(worker.device)
    print(f"slice: TorchTransformerLM {n_params / 1e6:.1f} M trained params "
          f"loaded on {card} in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED + 1)
    v, t, L = knobs["vocab_size"], knobs["seq_len"], knobs["n_layers"]

    def ids(n):
        return rng.integers(0, v, size=n).tolist()

    requests = [
        {"query": ids(512)},
        {"query": ids(1)},
        {"queries": [ids(3000), ids(100), ids(2), ids(1500)]},
        {"query": ids(2048)},
        {"queries": [ids(1), ids(700)]},
    ]
    app = PredictorService([worker.start()], device="cuda").start()
    served, latencies, tokens = [], [], []
    try:
        reset_launch_counts(attn)
        for req in requests:
            status, body, dt = post(app.url + "/predict", req)
            check(status == 200, f"/predict answered {status}")
            single = "query" in req
            preds = [body["prediction"]] if single else body["predictions"]
            queries = [req["query"]] if single else req["queries"]
            check(len(preds) == len(queries), "wrong number of predictions")
            served.extend(zip(queries, preds))
            latencies.append(dt)
            tokens.append(sum(min(len(q), t + 1) - 1 for q in queries
                              if len(q) >= 2))
        window = throughput_window(np, app.url, ids, t, card)
        launches = launch_counts(attn)
        status, body, _ = post(app.url + "/predict", {})
        check(status == 400, "an empty body must get 400")
        oov_checks(torch, np, attn, app.url, worker, served[0], v)
    finally:
        app.stop()
        worker.stop()

    scored = [(q, p) for q, p in served if len(q) >= 2]
    for q, p in served:
        check(isinstance(p, float) and math.isfinite(p),
              f"non-finite score {p}")
        if len(q) < 2:
            check(p == 0.0, "a query of fewer than 2 ids must score 0.0")
    n_scored = len(scored) + window
    check(launches[0] == L * n_scored,
          f"K1 launched {launches[0]} times for {n_scored} scored queries "
          f"of {L} layers: some layer did not go through the kernel")
    check(launches[3] == launches[0],
          f"only {launches[3]} of {launches[0]} K1 launches took wgmma")
    check(launches[1:3] == (0, 0), f"serving launched K2/K3 {launches[1:3]}")
    print(f"slice: {len(requests)} POST /predict requests, {len(served)} "
          f"queries ({len(scored)} scored), then {window} scored queries "
          f"in the window; K1 launches {launches[0]} = {L} x {n_scored}, "
          f"all on wgmma, K2 and K3 none", flush=True)
    print("slice: per-request latency ms " + ", ".join(
        f"{x * 1e3:.1f}" for x in latencies) + f" (smoke requests, one at "
        f"a time; the first pays the card's first-use costs) on {card}",
        flush=True)

    model = worker.model
    model.attention = attn.flash_attention_reference
    plain = model.predict([q for q, _ in scored])
    model.attention = attn.flash_attention
    diffs = [abs(a - p) for (_, a), p in zip(scored, plain)]
    print(f"slice: served scores {[round(p, 5) for _, p in scored]} vs "
          f"plain-attention {[round(p, 5) for p in plain]}, max |diff| "
          f"{max(diffs):.3e} (tolerance {TOL_SCORE})", flush=True)
    check(max(diffs) <= TOL_SCORE,
          "served scores disagree with the plain-attention model")
    query = scored[0][0]
    profile(torch, lambda: model.predict([query]),
            f"one predict of a {len(query)}-id query", card)
    model.destroy()
    return launches[0]


def oov_checks(torch, np, attn, url, worker, known, v):
    """Fault F1 on the card: a query with an id past the vocabulary
    answers nan and launches nothing; the worker then scores a known
    query exactly as before, and its model still generates."""
    query, score = known
    k0 = attn.flash_attention.launches
    status, body, _ = post(url + "/predict", {"query": [1, 2, 40000]})
    torch.cuda.synchronize()
    check(status == 200 and math.isnan(body["prediction"]),
          f"an id past the vocabulary answered {status} {body}")
    check(attn.flash_attention.launches == k0,
          "a query scored nan launched K1")
    status, body, _ = post(url + "/predict", {"query": query})
    check(status == 200 and body["prediction"] == score,
          f"after the out-of-vocabulary query a known query scored "
          f"{body} instead of {score}")
    model = worker.model
    eng = model.make_generator(page_size=16, n_pages=160, decode_batch=1,
                               max_new_cap=8, prefix_cache_entries=0)
    try:
        prompt = np.random.default_rng(SEED + 7).integers(0, v, 64).tolist()
        ref = model._forward(torch.tensor([prompt], device="cuda"))[0, -1]
        sid, tok = eng.admit(prompt, max_new=8, temperature=0.0)
        first, toks = tok, [tok]
        while sid in eng._seqs:
            (r,), _ = eng.step()
            toks.append(r[1])
        torch.cuda.synchronize()
    finally:
        eng.close()
    top2 = torch.topk(ref, 2).values
    check(len(toks) == 8 and all(0 <= x < v for x in toks),
          f"generation after the out-of-vocabulary query gave {toks}")
    check(first == int(ref.argmax()) or
          float(top2[0] - top2[1]) < NEAR_TIE,
          "the first generated token is not the full forward's argmax")
    print(f"slice: F1: POST /predict with id 40000 (V = {v}) answered nan "
          f"with no K1 launch; the worker then scored a known query "
          f"exactly as before ({score:.6f}) and its model generated 8 "
          f"greedy tokens (the first the full forward's argmax)",
          flush=True)


def stream_generate(url, body):
    """One ``POST /generate``: (frames, send time, arrival time of each
    NDJSON line), read line by line as the chunks arrive."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, times = [], []
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"/generate answered {resp.status}")
        check(resp.headers["Content-Type"] == "application/x-ndjson",
              f"/generate content type {resp.headers['Content-Type']}")
        for line in resp:
            frames.append(json.loads(line))
            times.append(time.perf_counter())
    return frames, t0, times


def check_stream(frames, max_new) -> int:
    """Every frame numbered without gaps, only the last ``done``, which
    says ``length`` with ``max_new`` tokens or ``eos``; returns the
    number of tokens."""
    check([f.get("seq") for f in frames] == list(range(len(frames))),
          f"frames not numbered without gaps: {[f.get('seq') for f in frames]}")
    check(all(not f["done"] for f in frames[:-1]) and frames[-1]["done"],
          "a stream did not end with its one done frame")
    last, n = frames[-1], sum(len(f["tok"]) for f in frames)
    check(last["n_tokens"] == n, f"n_tokens {last['n_tokens']} != {n} sent")
    check(last["finish"] == "eos" or (last["finish"] == "length"
                                      and n == max_new),
          f"stream finished {last['finish']!r} after {n} of {max_new} tokens")
    return n


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def decode_bound(s, B, T):
    """The decode step's least time: it reads every bf16 weight once
    (the projections and the tied embedding, which the unembedding
    reads whole) and gathers the fixed ``T``-slot K and V of every lane
    in every layer, whatever the lengths; its products are 2 FLOP per
    weight per lane."""
    n_w = 12 * s["layers"] * s["d"] ** 2 + s["v"] * s["d"]
    nbytes = 2 * n_w + s["layers"] * 2 * B * T * s["d"] * 2
    flops = 2.0 * n_w * B + s["layers"] * 4.0 * B * T * s["d"]
    return bound(flops, nbytes, 2), n_w * 2, nbytes


def engine_checks(torch, np, attn, card, model):
    """Checks (1), (2), (5) and (6) of the generate phase on an engine
    held directly: greedy parity with the full forward, K1 at every
    prefill bucket, sampling alone and packed, the decode step's time.
    Returns K1's numbers at the buckets."""
    import torch.nn.functional as F

    from rafiki_torch.models.lm_generate import PREFILL_BUCKETS

    s = model._dims()
    L, V = s["layers"], s["v"]
    t0 = time.perf_counter()
    eng = model.make_generator(**GEN_ENGINE)
    torch.cuda.synchronize()
    pool_gib = 2 * eng._k_pool.numel() * 2 / 2 ** 30
    print(f"generate: engine {GEN_ENGINE}: {eng.pages_per_seq} page slots "
          f"a lane ({eng.max_tokens} tokens), K and V pools {pool_gib:.3f} "
          f"GiB, decode step captured as a CUDA graph, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(eng._graph is not None, "the decode step was not captured")
    rng = np.random.default_rng(SEED + 5)

    # (1) Greedy parity with the full forward (K1) over the same prefix.
    prompt = rng.integers(0, V, 300).tolist()
    sid, tok = eng.admit(prompt, max_new=32, temperature=0.0)
    toks, errs, gaps, ties, step_k1 = list(prompt), [], [], 0, 0
    atol, rtol = TOL_LOGITS
    while True:
        ref = model._forward(torch.tensor([toks], device="cuda"))[0, -1]
        ref = ref.cpu().numpy()
        got = eng.last_logits[sid]
        err = np.abs(got - ref)
        errs.append(float(err.max()))
        check(bool((err <= atol + rtol * np.abs(ref)).all()),
              f"decode logits at position {len(toks)} disagree with the "
              f"full forward: max |diff| {err.max():.4f}")
        top2 = np.sort(ref)[-2:]
        gaps.append(float(top2[1] - top2[0]))
        if tok != int(np.argmax(ref)):
            check(gaps[-1] < NEAR_TIE, f"greedy token {tok} at position "
                  f"{len(toks)} is not the full forward's argmax "
                  f"{int(np.argmax(ref))} (top-2 gap {gaps[-1]:.4f})")
            ties += 1
        toks.append(tok)
        if sid not in eng._seqs:
            break
        k0 = attn.flash_attention.launches
        (r,), evicted = eng.step()
        step_k1 += attn.flash_attention.launches - k0
        check(not evicted and r[0] == sid, "unexpected step result")
        tok = r[1]
    check(len(toks) == len(prompt) + 32, f"{len(toks) - len(prompt)} tokens")
    check(step_k1 == 0, f"decode steps launched K1 {step_k1} times")
    print(f"generate (1): greedy 300-id prompt, 32 tokens: decode logits vs "
          f"the full forward (K1) over the same prefix at every step: max "
          f"|diff| {max(errs):.4e} (tolerance atol {atol}, rtol {rtol}); "
          f"greedy tokens equal to the full forward's argmax at "
          f"{32 - ties} of 32 steps ({ties} near-ties, top-2 gap < "
          f"{NEAR_TIE}, where they may part); smallest top-2 gap "
          f"{min(gaps):.4f}; decode steps launched K1 0 times", flush=True)

    # (2) K1 at every prefill bucket, against the plain attention.
    def late_kv(q, k, v, **kw):
        """K1 reading each key and value one row late: the planted fault
        that shows what the logits' limit can see."""
        k, v = (torch.cat([x[:, :, :1], x[:, :, :-1]], 2) for x in (k, v))
        return attn.flash_attention(q, k, v, **kw)

    def prefill_rows(ids, n, attention):
        """A prefill of ``n`` ids on ``attention`` into pages of its own:
        its last logits, and each layer's K and V rows, (2, L, n, d)
        f32."""
        ps = eng.page_size
        pages = [eng.pool.alloc() for _ in range(-(-n // ps))]
        rows = (torch.tensor(pages, device="cuda")[:, None] * ps
                + torch.arange(ps, device="cuda")).reshape(-1)[:n]
        pos = torch.zeros(ids.shape[1], dtype=torch.int64, device="cuda")
        pos[:n] = rows
        model.attention = attention
        try:
            logits = eng._run_prefill(ids, pos, n - 1).cpu().numpy()
        finally:
            model.attention = attn.flash_attention
        kv = torch.stack([eng._k_pool[:, rows], eng._v_pool[:, rows]])
        for p in pages:
            eng.pool.free(p)
        return logits, kv.float()

    def kv_rel(kv, ref):
        """The largest |kv - ref| of each K or V layer over that layer's
        largest |ref|, the largest over layers."""
        dims = (2, 3)
        return float(((kv - ref).abs().amax(dims)
                      / ref.abs().amax(dims)).max())

    buckets = []
    for n in PREFILL_LENGTHS:
        bucket = next(b for b in PREFILL_BUCKETS if b >= n)
        prompt = rng.integers(0, V, n).tolist()
        c0 = launch_counts(attn)
        sid, _ = eng.admit(prompt, max_new=1)
        c1 = launch_counts(attn)
        got = eng.last_logits[sid]
        eng.finish(sid)
        check(c1[0] - c0[0] == L and c1[3] - c0[3] == L
              and c1[1:3] == c0[1:3],
              f"a {n}-id prefill launched K1 {c1[0] - c0[0]} times "
              f"({c1[3] - c0[3]} wgmma), not {L}, and K2/K3 "
              f"{c1[1] - c0[1]}/{c1[2] - c0[2]} times, not 0")
        ids = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
        ids[0, :n] = torch.tensor(prompt, device="cuda")
        _, kv = prefill_rows(ids, n, attn.flash_attention)
        plain, kv_plain = prefill_rows(ids, n, attn.flash_attention_plain)
        planted, kv_planted = prefill_rows(ids, n, late_kv)
        err = np.abs(got - plain)
        planted_err = float(np.abs(planted - plain).max())
        kv_err, planted_kv_err = kv_rel(kv, kv_plain), kv_rel(kv_planted,
                                                              kv_plain)
        check(bool((err <= TOL_PREFILL).all()),
              f"a {n}-id prefill's logits disagree with the plain "
              f"attention: max |diff| {err.max():.4f}")
        check(kv_err <= TOL_KV, f"a {n}-id prefill's K/V rows disagree "
              f"with the plain attention's: {kv_err:.4e} of the layer's "
              f"max |x|")
        skipped = eng.prefill_skipped_total
        c0 = launch_counts(attn)
        sid, _ = eng.admit(prompt, max_new=1)
        c1 = launch_counts(attn)
        eng.finish(sid)
        check(eng.prefill_skipped_total == skipped + 1 and c1 == c0,
              f"a prefix hit ({n} ids) launched {c1[0] - c0[0]} K1")
        gen = torch.Generator(device="cuda").manual_seed(bucket)
        q, k, v = (torch.randn(1, s["h"], bucket, s["d"] // s["h"],
                               device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        check(attn.flash_forward_variant(q, k, v) == "wgmma",
              f"K1 would not take wgmma at {bucket} rows")
        ro, rl = attn.flash_attention_reference(q, k, v, causal=True,
                                                return_lse=True)
        c0 = launch_counts(attn)
        o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
        c1 = launch_counts(attn)
        check(c1[0] - c0[0] == 1 and c1[3] - c0[3] == 1,
              f"K1 did not launch on wgmma at {bucket} rows")
        err_o = (o.float() - ro.float()).abs()
        err_l = (lse - rl).abs()
        a_o, r_o = TOL_O["bfloat16"]
        check(bool((err_o <= a_o + r_o * ro.float().abs()).all())
              and bool((err_l <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all())
              and bool(torch.isfinite(o.float()).all()),
              f"K1 disagrees with its plain version at {bucket} rows: max "
              f"|do| {err_o.max().item():.3e}, |dlse| "
              f"{err_l.max().item():.3e}")
        ms = graph_ms(torch, lambda: attn._flash_forward(q, k, v, True,
                                                         None), 20)
        plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
            q, k, v, causal=True), 3)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        b_ms, b_by = attention_bound(1, s["h"], bucket, bucket,
                                     s["d"] // s["h"], True, 2)
        buckets.append({"rows": bucket, "prompt": n, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": float(err_o.max()),
                        "lse_max_abs_err": float(err_l.max()),
                        "logits_max_abs_err": float(err.max()),
                        "planted_logits_max_abs_err": planted_err,
                        "kv_rel_err": kv_err,
                        "planted_kv_rel_err": planted_kv_err})
        print(f"generate (2): {n}-id prompt, bucket {bucket}: K1 launches "
              f"{L}, all wgmma; last logits (max |logit| "
              f"{np.abs(plain).max():.3f}) vs the plain attention max "
              f"|diff| {err.max():.4e} (tolerance {TOL_PREFILL}); every "
              f"layer's K and V rows vs the plain attention's: max |diff| "
              f"over the layer's max |x| {kv_err:.4e} (tolerance {TOL_KV}); "
              f"with K1 reading K/V one row late (a "
              f"planted fault): logits {planted_err:.4e}, K/V rows "
              f"{planted_kv_err:.4e}; a prefix hit launched none; K1 at "
              f"(1,{s['h']},{bucket},{bucket},{s['d'] // s['h']}) causal "
              f"on random q, k, v against its plain version: max|do| "
              f"{err_o.max().item():.3e}, max|dlse| {err_l.max().item():.3e}"
              f" (tolerance as the kernel phase's); "
              f"{ms:.4f} ms (CUDA graph), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) on {card}", flush=True)
        del q, k, v, o, lse, ro, rl

    # (5) Sampling: the same (seed, prompt) alone and packed with seven
    # other requests.
    prompt = rng.integers(0, V, 200).tolist()
    sid, tok = eng.admit(prompt, max_new=48, temperature=0.8, seed=1234)
    alone = [tok]
    while sid in eng._seqs:
        alone += [t for q, t, _ in eng.step()[0] if q == sid]
    others = [eng.admit(rng.integers(0, V, int(n)).tolist(), max_new=64,
                        temperature=float(t), seed=int(n))[0]
              for n, t in zip(rng.integers(50, 500, 7), [0.8, 0.0] * 4)]
    sid, tok = eng.admit(prompt, max_new=48, temperature=0.8, seed=1234)
    lane = eng._seqs[sid].lane
    packed = [tok]
    while sid in eng._seqs:
        res, evicted = eng.step()
        check(not evicted, "the sampling check was preempted")
        packed += [t for q, t, _ in res if q == sid]
    for o in others:
        eng.finish(o)
    print(f"generate (5): 200-id prompt, seed 1234, temperature 0.8, 48 "
          f"tokens: alone (lane 0) and packed with 7 others (lane {lane}) "
          f"identical: {packed == alone}", flush=True)
    check(packed == alone, "sampled tokens differ alone and packed")

    # (6) The decode step at 8 full lanes: graph replay, eager, bound.
    B, T = eng.decode_batch, eng.max_tokens
    for _ in range(B):
        eng.admit(rng.integers(0, V, 2040).tolist(), max_new=256,
                  temperature=0.8, seed=7)
    check(eng.resident() == B, f"{eng.resident()} lanes resident")
    eng._stage_inputs()
    eager = eng._decode(*eng._decode_args())
    graph = eng._run_decode()
    torch.cuda.synchronize()
    same = (bool(torch.equal(eager[0], graph[0]))
            and bool(torch.equal(eager[1], graph[1])))
    check(same, "the decode graph's tokens or logits differ from the "
          "eager step's on the same inputs")
    graph_step = time_ms(torch, eng._graph.replay, 50)
    eager_step = time_ms(torch, lambda: eng._decode(*eng._decode_args()), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        eng.step()
    wall_step = (time.perf_counter() - t0) / 20 * 1e3
    (b_ms, b_by), w_bytes, nbytes = decode_bound(s, B, T)
    prof = profile(torch, lambda: eng._decode(*eng._decode_args()),
                   f"one eager decode step at {B} full lanes", card, 12)
    gather_share = eager_device = None
    if prof is not None:
        rows, busy = prof
        eager_device = busy / 1e3
        # The gather is PyTorch's gather kernel for rows, its index
        # kernel for the head-major layout; index_copy_ writes the new rows.
        gather_us = sum(us for us, _, key in rows if "gather" in key or (
            "index" in key and "index_copy" not in key))
        gather_share = gather_us / busy
        print(f"generate (6): the K/V gather (PyTorch's gather and index "
              f"kernels, not index_copy_) takes {100 * gather_share:.1f}% "
              f"of the eager step's device time ({gather_us / 1e3:.3f} of "
              f"{busy / 1e3:.3f} ms)", flush=True)
    eager_dev = "not measured" if eager_device is None else \
        f"{eager_device:.4f} ms"
    print(f"generate (6): decode step at {B} full lanes ({T} K/V slots a "
          f"lane): CUDA graph replay {graph_step:.4f} ms (device time, "
          f"CUDA events); eager {eager_step:.4f} ms between CUDA events "
          f"(host-bound: the card waits on the host's launches), of which "
          f"the device is busy {eager_dev} (profiler); one step() on the "
          f"host clock {wall_step:.4f} ms (staging, replay, tokens and "
          f"logits back); bound {b_ms:.4f} ms ({b_by}: {w_bytes / 1e9:.3f} "
          f"GB of bf16 weights + {(nbytes - w_bytes) / 1e9:.3f} GB of K/V "
          f"gather at 3.35 TB/s); graph and eager steps equal bit for "
          f"bit on the same inputs: {same} on {card}", flush=True)
    eng.close()
    check(eng.pool.used_pages == 0, "close() left pages allocated")
    return {"buckets": buckets, "decode_graph_ms": graph_step,
            "decode_eager_ms": eager_step,
            "decode_eager_device_ms": eager_device,
            "decode_step_wall_ms": wall_step,
            "decode_bound_ms": b_ms, "decode_gather_share": gather_share}


def generate_window(torch, np, attn, card, params, engine_cfg, bodies,
                    what):
    """``bodies`` as ``POST /generate`` requests from ``GEN_CLIENTS``
    threads at once to a worker built with ``engine_cfg``; checks every
    stream and K1's launches (``n_layers`` a prefill, all wgmma; K2 and
    K3 none). Returns the scheduler's stats, the engine's evictions, the
    K1 launches and the client-side numbers."""
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.worker import InferenceWorker

    L = FLAGSHIP["n_layers"]
    worker = InferenceWorker(TorchTransformerLM, FLAGSHIP, params,
                             device="cuda", generate=engine_cfg)
    eng = worker.scheduler.engine
    app = PredictorService([worker.start()], device="cuda").start()
    try:
        reset_launch_counts(attn)
        family0 = lm_family()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(GEN_CLIENTS) as pool:
            results = list(pool.map(
                lambda b: stream_generate(app.url, b), bodies))
        secs = time.perf_counter() - t0
        launches = launch_counts(attn)
        stats = worker.scheduler.stats()
        family = {k: v - family0[k] for k, v in lm_family().items()}
    finally:
        app.stop()
        worker.stop()
    check(eng.pool.used_pages == 0, "stop() left pages allocated")
    n_tok = sum(check_stream(fr, b["max_new"])
                for (fr, _, _), b in zip(results, bodies))
    check(stats["errors"] == 0, f"{stats['errors']} decode loop errors")
    # The registry's token family (observe.lm) against what the clients
    # were streamed.
    check(family["tokens"] == n_tok and family["ttft"] == len(bodies)
          and family["dispatches"] == stats["decode_dispatches"]
          and family["preemptions"] == stats["preemptions"],
          f"the rafiki_tpu_lm_* family counted {family} for {n_tok} "
          f"streamed tokens of {len(bodies)} requests")
    print(f"generate {what}: the registry's rafiki_tpu_lm_* family: "
          f"{family['tokens']:.0f} tokens (= streamed), "
          f"{family['ttft']:.0f} TTFT observations (= requests), "
          f"{family['dispatches']:.0f} decode dispatches, prefills run "
          f"{family['prefill_run']:.0f} and cached "
          f"{family['prefill_cached']:.0f}, {family['preemptions']:.0f} "
          f"preemptions", flush=True)
    prefills = stats["prefills_run"]
    check(launches[0] == L * prefills and launches[3] == launches[0],
          f"K1 launched {launches[0]} times ({launches[3]} wgmma) for "
          f"{prefills} prefills of {L} layers")
    check(launches[1:3] == (0, 0), f"generation launched K2/K3 "
          f"{launches[1:3]}")
    ttft = [(ts[0] - t) * 1e3 for _, t, ts in results]
    itl = [(b - a) * 1e3 for _, _, ts in results for a, b in zip(ts, ts[1:])]
    step_tokens = stats["tokens"] - prefills - stats["prefills_cached"]
    lanes = step_tokens / max(1, stats["decode_dispatches"])
    print(f"generate {what}: {len(bodies)} POST /generate streams from "
          f"{GEN_CLIENTS} clients, every stream complete with contiguous "
          f"frames: {n_tok} tokens in {secs:.4f} s = {n_tok / secs:.1f} "
          f"tokens/s; TTFT p50 {percentile(ttft, 50):.2f} ms, p99 "
          f"{percentile(ttft, 99):.2f} ms; inter-token p50 "
          f"{percentile(itl, 50):.2f} ms, p99 {percentile(itl, 99):.2f} ms "
          f"(client side); {stats['decode_dispatches']} decode steps, "
          f"{lanes:.3f} live lanes a step; prefills run {prefills}, "
          f"skipped {stats['prefills_cached']}; preemptions "
          f"{stats['preemptions']} (engine evictions "
          f"{eng.evictions_total}); K1 launches {launches[0]} = {L} x "
          f"{prefills}, all wgmma, K2 and K3 none on {card}", flush=True)
    return {"stats": stats, "evictions": eng.evictions_total,
            "k1_launches": launches[0], "tokens": n_tok, "secs": secs,
            "tokens_per_s": n_tok / secs,
            "ttft_ms": (percentile(ttft, 50), percentile(ttft, 99)),
            "itl_ms": (percentile(itl, 50), percentile(itl, 99)),
            "lanes": lanes}


def lm_family():
    """The registry's token serving family (``observe.lm``), as numbers:
    tokens, TTFT and inter-token observations, decode dispatches,
    prefills run and cached, preemptions."""
    from rafiki_torch.observe import metrics

    reg = metrics.registry()

    def val(name, **labels):
        fam = reg.find(name)
        return 0.0 if fam is None else float(fam.value(**labels))

    def count(name):
        fam = reg.find(name)
        return 0 if fam is None else fam.count()

    return {"tokens": val("rafiki_tpu_lm_tokens_total"),
            "ttft": count("rafiki_tpu_lm_time_to_first_token_seconds"),
            "inter_token": count("rafiki_tpu_lm_inter_token_seconds"),
            "dispatches": val("rafiki_tpu_lm_decode_dispatches_total"),
            "prefill_run": val("rafiki_tpu_lm_prefill_total", mode="run"),
            "prefill_cached": val("rafiki_tpu_lm_prefill_total",
                                  mode="cached"),
            "preemptions": val("rafiki_tpu_lm_preemptions_total")}


def generate_phase(torch, np, attn, card, params):
    """Generative serving of the trained flagship: checks (1), (2), (5)
    and (6) on an engine held directly, then (3) the window of streamed
    requests and (4) preemption through ``POST /generate``. Returns K1's
    launches on the generate path and the phase's numbers."""
    from rafiki_torch.models import TorchTransformerLM

    model = TorchTransformerLM(device="cuda",
                               **TorchTransformerLM.validate_knobs(FLAGSHIP))
    model.load_parameters(params)
    out = engine_checks(torch, np, attn, card, model)
    model.destroy()
    torch.cuda.empty_cache()

    # (3) The window: a quarter of the prompts are one shared 512-id
    # prompt, the rest 16 to 2000 random ids; greedy and sampled.
    V = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(SEED + 6)
    shared = rng.integers(0, V, 512).tolist()
    bodies = [{"tokens": (shared if i % 4 == 0 else rng.integers(
                   0, V, int(rng.integers(16, 2001))).tolist()),
               "max_new": int(rng.integers(64, 257)),
               "temperature": 0.8 if rng.random() < 0.5 else 0.0,
               "seed": i}
              for i in range(GEN_REQUESTS)]
    # The token family exists while RAFIKI_TPU_SERVING_GENERATE is on,
    # read once a process: on for the two windows, then off again.
    import os

    from rafiki_torch.observe import lm

    saved = os.environ.get(lm.GENERATE_ENV)
    os.environ[lm.GENERATE_ENV] = "1"
    lm.reset_for_tests()
    try:
        window = generate_window(torch, np, attn, card, params, GEN_ENGINE,
                                 bodies, "(3)")
        check(window["stats"]["prefills_cached"] >= 1,
              "the shared prompt never hit the prefix cache")

        # (4) Preemption: 4 lanes of 100-id prompts growing to 300
        # tokens need 76 pages; the pool has 39.
        small = dict(GEN_ENGINE, decode_batch=4, n_pages=40,
                     prefix_cache_entries=0)
        bodies = [{"tokens": rng.integers(0, V, 100).tolist(),
                   "max_new": 200, "temperature": 0.0, "seed": i}
                  for i in range(4)]
        pre = generate_window(torch, np, attn, card, params, small, bodies,
                              "(4) preemption, engine " + json.dumps(small))
    finally:
        if saved is None:
            os.environ.pop(lm.GENERATE_ENV, None)
        else:
            os.environ[lm.GENERATE_ENV] = saved
        lm.reset_for_tests()
    check(pre["evictions"] >= 1 and pre["stats"]["preemptions"] >= 1,
          "pool pressure never preempted a sequence")
    out.update(window=window, preemption=pre)
    return window["k1_launches"] + pre["k1_launches"], out


def device_busy(torch, fn):
    """Run ``fn()`` under ``torch.profiler`` (device activity only) and
    return (wall s, device busy s, {kernel name: device s}). Busy is the
    union of the kernels' and copies' intervals on the card. Unlike
    ``profile``, it runs ``fn`` once and reads the raw events: a trial
    is thousands of steps, too many events for ``key_averages``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from rafiki_torch.observe.profiling import PROFILER_LOCK

    torch.cuda.synchronize()
    with PROFILER_LOCK, torch_profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e9
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, busy / 1e9, by_name


def automl_window(np, url, images, card, tag="automl:",
                  deployed=AUTOML_DEPLOY):
    """``AUTOML_WINDOW`` single-image requests from ``AUTOML_CLIENTS``
    clients at once to ``deployed`` workers: queries per second and
    latency percentiles, printed after ``tag``."""
    from concurrent.futures import ThreadPoolExecutor

    queries = [(img.astype(np.float32) / 255.0).tolist() for img in images]

    def one(q):
        status, body, dt = post(url + "/predict", {"query": q})
        check(status == 200, f"/predict answered {status}")
        p = body["prediction"]
        check(isinstance(p, list) and len(p) == AUTOML_DATA["n_classes"]
              and abs(sum(p) - 1.0) < 1e-4, f"not a distribution: {p}")
        return dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(AUTOML_CLIENTS) as pool:
        lat = sorted(pool.map(one, queries))
    secs = time.perf_counter() - t0
    pct = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3
           for p in (50, 90, 99)}
    print(f"{tag} window of {len(queries)} single-image requests from "
          f"{AUTOML_CLIENTS} clients to {deployed} workers: "
          f"{len(queries) / secs:.2f} queries/s; latency p50 {pct[50]:.2f} "
          f"ms, p90 {pct[90]:.2f} ms, p99 {pct[99]:.2f} ms on {card}",
          flush=True)
    return {"qps": len(queries) / secs, "p50_ms": pct[50],
            "p90_ms": pct[90], "p99_ms": pct[99]}


def automl_phase(torch, np, attn, card):
    """Rafiki's AutoML loop on TorchFeedForward: a random search of
    ``AUTOML_TRIALS`` trials through ``TrialRunner`` on the card, with
    the meta and param stores under a temporary directory, then the
    ``AUTOML_DEPLOY`` best trials deployed as inference workers behind
    one predictor. Checks (a) to (e) of the phase; returns its
    numbers."""
    import os
    import tempfile

    from rafiki_torch.advisor import RandomAdvisor
    from rafiki_torch.constants import (BudgetOption, TaskType,
                                        TrainJobStatus, TrialStatus)
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import TorchFeedForward
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.worker import InferenceWorker, TrialRunner

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train, val = make_synthetic_image_dataset(tmp, seed=SEED,
                                                  **AUTOML_DATA)
        ds = load_image_dataset(train)
        print(f"automl: synthetic {AUTOML_DATA['name']}-shaped set: "
              f"{ds.size} train and {AUTOML_DATA['n_val']} val images of "
              f"{ds.image_shape}, {ds.images.nbytes / 1e6:.1f} MB of uint8 "
              f"train images to stage on the card; made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        meta = MetaStore(os.path.join(tmp, "meta.db"))
        params = ParamStore(os.path.join(tmp, "params"))
        user = meta.create_user("smoke@example.com", "-", "MODEL_DEVELOPER")
        model = meta.create_model(
            user["id"], "ff", TaskType.IMAGE_CLASSIFICATION,
            "rafiki_torch.models.feedforward:TorchFeedForward", {})
        budget = {BudgetOption.MODEL_TRIAL_COUNT: AUTOML_TRIALS}
        job = meta.create_train_job(user["id"], "smoke",
                                    TaskType.IMAGE_CLASSIFICATION, budget,
                                    train, val, TrainJobStatus.RUNNING)
        sub = meta.create_sub_train_job(job["id"], model["id"], "RUNNING")
        advisor = RandomAdvisor(TorchFeedForward.get_knob_config(),
                                seed=SEED)
        runner = TrialRunner(TorchFeedForward, advisor, train, val, meta,
                             params, sub["id"], model_id=model["id"],
                             budget=budget, device="cuda")
        t0 = time.perf_counter()
        rows = runner.run()
        search_s = time.perf_counter() - t0

        # (a) Every trial completed, well above chance.
        check(len(rows) == AUTOML_TRIALS, f"{len(rows)} trials ran")
        trials = []
        for r in rows:
            check(r["status"] == TrialStatus.COMPLETED,
                  f"trial {r['no']} {r['status']}: {r.get('error')}")
            logs = [x["record"] for x in meta.get_trial_logs(r["id"])]
            epochs = [x["values"] for x in logs
                      if x["type"] == "values" and "epoch" in x["values"]]
            k = r["knobs"]
            steps = len(epochs) * (ds.size // k["batch_size"])
            secs = r["finished_at"] - r["started_at"]
            last = epochs[-1]
            trials.append({"no": r["no"], "knobs": k, "steps": steps,
                           "seconds": secs,
                           "steps_per_sec": last["steps_per_sec"],
                           "val_acc": r["score"],
                           "chip_util": last.get("chip_util"),
                           "losses": [e["loss"] for e in epochs]})
            print(f"automl: trial {r['no']}: knobs {json.dumps(k)}: "
                  f"{steps} steps in {secs:.2f} s, "
                  f"{last['steps_per_sec']:.1f} steps/s, epoch losses "
                  f"{[round(e['loss'], 4) for e in epochs]}, val accuracy "
                  f"{r['score']:.4f}, chip_util {last.get('chip_util')} "
                  f"on {card}", flush=True)
            check(r["score"] >= AUTOML_MIN_ACC,
                  f"trial {r['no']} val accuracy {r['score']:.4f} is below "
                  f"{AUTOML_MIN_ACC}")
        print(f"automl: search of {AUTOML_TRIALS} trials "
              f"(RandomAdvisor seed {SEED}, MODEL_TRIAL_COUNT "
              f"{AUTOML_TRIALS}) in {search_s:.2f} s: "
              f"{AUTOML_TRIALS * 3600 / search_s:.1f} trials/hour on "
              f"{card}", flush=True)

        # The device's busy share over one trial: the search's trial of
        # the largest batch, trained and evaluated again under the
        # profiler.
        prof_knobs = max((t["knobs"] for t in trials),
                         key=lambda k: k["batch_size"])

        def one_trial():
            m = TorchFeedForward(device="cuda", **prof_knobs)
            m.train(train)
            m.evaluate(val)
            m.destroy()

        wall, busy, by_name = device_busy(torch, one_trial)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"automl: profiled trial (knobs {json.dumps(prof_knobs)}): "
              f"wall {wall:.3f} s, device busy {busy:.3f} s "
              f"({100 * busy / wall:.1f}%) on {card}; top kernels "
              + "; ".join(f"{n[:60]} {t * 1e3:.1f} ms" for n, t in top),
              flush=True)

        # The trained trials and the val set stay for the ensemble
        # phase's int8 check.
        vds = load_image_dataset(val)
        out["ff_trials"] = [(r["knobs"], params.load(r["params_id"]))
                            for r in rows]
        out["ff_val"] = (vds.images, vds.labels)

        # Deploy the best trials.
        best = meta.get_best_trials_of_train_job(job["id"],
                                                 max_count=AUTOML_DEPLOY)
        check(len(best) == AUTOML_DEPLOY, f"{len(best)} trials to deploy")
        loaded = [params.load(t["params_id"]) for t in best]
        workers = [InferenceWorker(TorchFeedForward, t["knobs"], p,
                                   device="cuda").start()
                   for t, p in zip(best, loaded)]
        app = PredictorService(workers, device="cuda").start()
        fixed = vds.images[:64]
        try:
            # (b) Five POST /predict checks: each served prediction is
            # the mean of the two workers' own.
            n_checked, worst = 0, 0.0
            for i in range(5):
                imgs = vds.images[8 * i:8 * i + 1 + i]
                floats = (imgs.astype(np.float32) / 255.0).tolist()
                body = ({"query": floats[0]} if i % 2 == 0
                        else {"queries": floats})
                status, resp, _ = post(app.url + "/predict", body)
                check(status == 200, f"/predict answered {status}")
                served = np.asarray([resp["prediction"]] if i % 2 == 0
                                    else resp["predictions"])
                qs = floats[:1] if i % 2 == 0 else floats
                own = np.mean([w.predict(qs, timeout=60) for w in workers],
                              axis=0)
                err = float(np.abs(served - own).max())
                worst = max(worst, err)
                check(err <= TOL_ENSEMBLE, f"served prediction differs "
                      f"from the workers' mean by {err:.3e}")
                n_checked += len(qs)
            print(f"automl: {AUTOML_DEPLOY} best trials (val accuracy "
                  f"{[round(t['score'], 4) for t in best]}) deployed; 5 "
                  f"POST /predict requests, {n_checked} queries: served = "
                  f"mean of the workers' own predict, max |diff| "
                  f"{worst:.3e} (tolerance {TOL_ENSEMBLE})", flush=True)
            out["window"] = automl_window(
                np, app.url, vds.images[:AUTOML_WINDOW], card)
            profile(torch, lambda: workers[0].model.predict(list(fixed[:1])),
                    "one worker's predict of one image", card, top=5)
        finally:
            app.stop()
            for w in workers:
                w.stop()

        # (c) The card's probabilities against the CPU's, same params.
        best_knobs = best[0]["knobs"]
        on_card = TorchFeedForward(device="cuda", **best_knobs)
        on_card.load_parameters(loaded[0])
        on_cpu = TorchFeedForward(device="cpu", **best_knobs)
        on_cpu.load_parameters(loaded[0])
        diff = float(np.abs(on_card.predict_proba(fixed)
                            - on_cpu.predict_proba(fixed)).max())
        check(diff <= TOL_PROB, f"card vs CPU probabilities: {diff:.3e}")
        print(f"automl: (c) best trial's probabilities for {len(fixed)} val "
              f"images, card vs CPU plain path: max |diff| {diff:.3e} "
              f"(tolerance {TOL_PROB})", flush=True)

        # (d) A params file written on the card loads back bit-exactly.
        dumped = on_card.dump_parameters()
        pid = params.save(dumped, session_id="roundtrip")
        back = params.load(pid)
        check(set(back) == set(dumped) and all(
            back[k].dtype == np.asarray(dumped[k]).dtype
            and np.array_equal(back[k], dumped[k]) for k in dumped),
            "a params file written on the card did not load back exactly")
        again = TorchFeedForward(device="cuda", **best_knobs)
        again.load_parameters(back)
        check(np.array_equal(again.predict_proba(fixed),
                             on_card.predict_proba(fixed)),
              "reloaded params predict differently")
        size = os.path.getsize(os.path.join(params.params_dir,
                                            f"{pid}.safetensors"))
        print(f"automl: (d) params file written on the card ({size} bytes, "
              f"{len(dumped)} tensors) loaded back bit for bit", flush=True)
        for m in (on_card, on_cpu, again):
            m.destroy()
        params.close()
        meta.close()

    # (e) The phase ran none of the attention kernels.
    launches = launch_counts(attn)
    check(launches[:3] == (0, 0, 0),
          f"the automl phase launched K1/K2/K3 {launches[:3]}")
    phase_s = time.perf_counter() - t_phase
    print(f"automl: (e) K1, K2 and K3 launched 0 times in the phase; phase "
          f"took {phase_s:.1f} s", flush=True)
    out.update(trials=trials, search_s=search_s,
               trials_per_hour=AUTOML_TRIALS * 3600 / search_s,
               busy_share=busy / wall, phase_s=phase_s)
    return out


def wait_train(client, job_id):
    """Wait for a train job to end (polled at 0.1 s); its final row."""
    return client.wait_until_train_job_done(job_id, timeout=900, poll=0.1)


def platform_window(np, client, host, images, card, tag="platform: (a)",
                    what=f"one worker serving a {PLATFORM_DEPLOY}-trial bin"):
    """One single-image ``Client.predict`` call an image from
    ``AUTOML_CLIENTS`` threads at once: queries per second, latency
    percentiles and the answers, in the images' order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(img):
        t0 = time.perf_counter()
        p = client.predict(host, query=img)["prediction"]
        dt = time.perf_counter() - t0
        check(len(p) == AUTOML_DATA["n_classes"]
              and abs(sum(p) - 1.0) < 1e-4, f"not a distribution: {p}")
        return dt, p

    t0 = time.perf_counter()
    with ThreadPoolExecutor(AUTOML_CLIENTS) as pool:
        answers = list(pool.map(one, list(images)))
    secs = time.perf_counter() - t0
    lat = sorted(dt for dt, _ in answers)
    pct = {q: lat[min(len(lat) - 1, int(q / 100 * len(lat)))] * 1e3
           for q in (50, 90, 99)}
    print(f"{tag} window of {len(lat)} single-image requests from "
          f"{AUTOML_CLIENTS} clients through Client.predict to {what}: "
          f"{len(lat) / secs:.2f} queries/s; latency p50 {pct[50]:.2f} ms, "
          f"p90 {pct[90]:.2f} ms, p99 {pct[99]:.2f} ms on {card}",
          flush=True)
    return {"qps": len(lat) / secs, "p50_ms": pct[50], "p90_ms": pct[90],
            "p99_ms": pct[99],
            "answers": np.asarray([p for _, p in answers], np.float64)}


def admin_get(port, path, token=None):
    """The text of one admin ``GET``, with the bearer token if given."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        headers={"Authorization": f"Bearer {token}"} if token else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


SERVING_FAMILIES = ("rafiki_tpu_serving_requests_total",
                    "rafiki_tpu_serving_batches_total",
                    "rafiki_tpu_serving_batched_queries_total",
                    "rafiki_tpu_serving_stage_seconds_bucket",
                    "rafiki_tpu_serving_shards_total",
                    "rafiki_tpu_serving_replica_gather_seconds_bucket",
                    "rafiki_tpu_http_request_seconds_bucket")
TRACE_SPANS = ("http POST /predict", "predictor.scatter", "predictor.gather",
               "worker.predict")


def front_routes(np, admin_port, token, host, inf_id, image, card):
    """(e) The serving front's routes on the platform: a request sent
    with ``X-Trace-Id`` shows its edge, batcher and worker spans in the
    admin's ``GET /trace/<id>``; the admin's and the predictor's ``GET
    /metrics`` parse and hold the serving families; ``GET
    /inference_jobs/<id>/stats`` is the predictor's snapshot."""
    import uuid

    from rafiki_torch.cache import encode_payload
    from rafiki_torch.observe.metrics import parse_exposition

    tid = uuid.uuid4().hex
    req = urllib.request.Request(
        f"http://{host}/predict",
        data=json.dumps({"query": encode_payload(image)}).encode(),
        headers={"Content-Type": "application/json", "X-Trace-Id": tid})
    with urllib.request.urlopen(req, timeout=60) as r:
        echoed = r.headers.get("X-Trace-Id", "")
        r.read()
    trace = json.loads(admin_get(admin_port, f"/trace/{tid}", token))
    names = [sp["name"] for sp in trace["spans"]]
    check(echoed.startswith(tid) and all(n in names for n in TRACE_SPANS),
          f"trace {tid}: spans {names}, echoed {echoed!r}")
    fams = {}
    for what, text in (("admin", admin_get(admin_port, "/metrics")),
                       ("predictor", urllib.request.urlopen(
                           f"http://{host}/metrics", timeout=60).read()
                        .decode())):
        fams[what] = parse_exposition(text)
        missing = [f for f in SERVING_FAMILIES if f not in fams[what]]
        check(not missing, f"the {what}'s /metrics lacks {missing}")
    stats = json.loads(admin_get(admin_port, f"/inference_jobs/{inf_id}/stats",
                                 token))
    direct = stats_of(host)
    check(stats["inference_job_id"] == inf_id
          and stats["service"] == direct["service"]
          and set(direct) <= set(stats) and stats["requests"] >= 1,
          f"/inference_jobs/<id>/stats {sorted(stats)} against the "
          f"predictor's {sorted(direct)}")
    spans = {sp["name"]: sp["dur_ms"] for sp in trace["spans"]}
    print(f"front: (e) GET /trace/<id> of a traced /predict: "
          f"{trace['n_spans']} spans {names} (ms: "
          f"{[spans[n] for n in TRACE_SPANS]}); GET /metrics of the admin "
          f"({len(fams['admin'])} families) and the predictor "
          f"({len(fams['predictor'])}) parse with the serving families; GET "
          f"/inference_jobs/<id>/stats = the predictor's /stats "
          f"(service {stats['service']}, {stats['requests']} requests, "
          f"{stats['batches']} batches) on {card}", flush=True)
    return {"spans": names, "n_families": len(fams["admin"])}


def platform_phase(torch, np, attn, card, automl):
    """Rafiki's platform on the card, driven as a user drives it: a
    ``LocalPlatform`` (its default device, CUDA) with the admin REST
    service, and ``Client`` over HTTP. (a) the quickstart's flow on
    TorchFeedForward: ``AUTOML_TRIALS`` trials proposed by the advisor
    service, the 2 best deployed (one worker, a two-trial bin, on one
    card), checked requests and a window; (b) a second train job
    time-sliced on the card while (a)'s job serves, which must not move
    (a)'s answers by a bit; (c) the flagship LM uploaded as
    ``model_source``, one trial trained on K1, K2 and K3 and served on
    K1. Returns the phase's numbers and (c)'s K1, K2 and K3 launches."""
    import os
    import tempfile

    from rafiki_torch.cache import Cache
    from rafiki_torch.client import Client
    from rafiki_torch.constants import (BudgetOption, TaskType, TrialStatus,
                                        UserType)
    from rafiki_torch.datasets import (make_synthetic_image_dataset,
                                       make_synthetic_token_dataset)
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.model.torch_model import stack_members
    from rafiki_torch.models import TorchFeedForward, TorchTransformerLM
    from rafiki_torch.platform import LocalPlatform

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        train, val = make_synthetic_image_dataset(
            os.path.join(tmp, "images"), seed=SEED, **AUTOML_DATA)
        vds = load_image_dataset(val)
        p = LocalPlatform(workdir=os.path.join(tmp, "platform"), http=True)
        try:
            check(p.allocator.n_chips == torch.cuda.device_count(),
                  f"the allocator counts {p.allocator.n_chips} chips")
            root = Client(admin_port=p.admin_port)
            root.login("superadmin@rafiki", "rafiki")
            root.create_user("dev@example.com", "pw",
                             UserType.MODEL_DEVELOPER)
            dev = Client(admin_port=p.admin_port)
            token = dev.login("dev@example.com", "pw")["token"]
            model = dev.create_model(
                "ff", TaskType.IMAGE_CLASSIFICATION,
                "rafiki_torch.models.feedforward:TorchFeedForward")

            # (a) The search through the advisor and train services.
            t0, wall0 = time.perf_counter(), time.time()
            job = dev.create_train_job(
                "smoke", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
                {BudgetOption.MODEL_TRIAL_COUNT: AUTOML_TRIALS}, train, val)
            # No advisor type: the advisor service picks as the
            # reference's registry does (Bayes for this knob space; its
            # first 5 proposals are the random advisor's draws).
            (adv_svc,) = [s for s in dev.get_services()
                          if s["service_type"] == "ADVISOR"
                          and s["status"] in ("DEPLOYING", "RUNNING")]
            adv_name = type(p.container.get(adv_svc["id"]).advisor).__name__
            done = wait_train(dev, job["id"])
            search_s = time.perf_counter() - t0
            check(done["status"] == "STOPPED", f"train job {done['status']}")
            trials = dev.get_trials_of_train_job(job["id"])
            check(len(trials) == AUTOML_TRIALS and all(
                t["status"] == TrialStatus.COMPLETED
                and t["score"] >= AUTOML_MIN_ACC for t in trials),
                f"trials: {[(t['status'], t['score']) for t in trials]}")
            tph = AUTOML_TRIALS * 3600 / search_s
            rows = sorted((p.meta.get_trial(t["id"]) for t in trials),
                          key=lambda r: r["started_at"])
            trial_s = [r["finished_at"] - r["started_at"] for r in rows]
            print(f"platform: (a) train job of {AUTOML_TRIALS} trials "
                  f"(advisor service, {adv_name}, seed 0) through the admin "
                  f"REST service: STOPPED in {search_s:.2f} s, "
                  f"{tph:.1f} trials/hour, against "
                  f"{automl['trials_per_hour']:.1f} in process (automl "
                  f"phase; the platform's own cost: "
                  f"{search_s - automl['search_s']:.2f} s); first trial "
                  f"started {rows[0]['started_at'] - wall0:.2f} s after the "
                  f"request, trials {[round(x, 2) for x in trial_s]} s, the "
                  f"last ended {wall0 + search_s - rows[-1]['finished_at']:.2f}"
                  f" s before STOPPED was read; knobs "
                  f"{[r['knobs'] for r in rows]}; val accuracy "
                  f"{[round(t['score'], 4) for t in trials]} on {card}",
                  flush=True)

            inf = dev.create_inference_job(job["id"],
                                           max_models=PLATFORM_DEPLOY)
            bins = [w["trial_id"] for w in
                    p.meta.get_inference_job_workers(inf["id"])
                    if w["trial_id"] != "__predictor__"]
            check(len(bins) == 1 and sorted(bins[0].split(",")) ==
                  sorted(inf["trial_ids"]),
                  f"{PLATFORM_DEPLOY} trials on one card serve as bins "
                  f"{bins}")
            host = dev.get_inference_job(inf["id"])["predictor_host"]
            (wid,) = [w["service_id"] for w in
                      p.meta.get_inference_job_workers(inf["id"])
                      if w["trial_id"] != "__predictor__"]
            cache, deadline = Cache(p.bus), time.monotonic() + 300
            while wid not in cache.running_worker_info(inf["id"]):
                check(time.monotonic() < deadline,
                      "the bin's worker did not register")
                time.sleep(0.05)
            info = cache.running_worker_info(inf["id"])[wid]
            ens = p.container.get(wid).model
            check(info.get("stacked") is True and ens.stacked is not None,
                  f"the 2-trial bin did not stack: registration {info}")
            members = []
            for tid in bins[0].split(","):
                row = p.meta.get_trial(tid)
                m = TorchFeedForward(device="cuda", **row["knobs"])
                m.load_parameters(p.params.load(row["params_id"]))
                members.append(m)
            # The bin serves its members' stacked rows: the served answer
            # is their float64 mean; each member's stacked rows are its
            # own predict within TOL_STACKED_FF.
            group = stack_members(members)
            worst, worst_own, n_checked = 0.0, 0.0, 0
            for i in range(PLATFORM_CHECKED):
                imgs = [vds.images[8 * i + j] for j in range(1 + i)]
                if i % 2 == 0:
                    served = [dev.predict(host, query=imgs[0])
                              ["prediction"]]
                    imgs = imgs[:1]
                else:
                    served = dev.predict(host, queries=imgs)["predictions"]
                rows = stacked_rows(np, group, np.stack(imgs))
                err = float(np.abs(np.asarray(served)
                                   - rows.astype(np.float64).mean(0)).max())
                own = np.asarray([m.predict(imgs) for m in members])
                worst = max(worst, err)
                worst_own = max(worst_own, float(np.abs(rows - own).max()))
                check(err <= TOL_ENSEMBLE, f"served differs from the "
                      f"members' stacked mean by {err:.3e}")
                n_checked += len(imgs)
            check(worst_own <= TOL_STACKED_FF, f"stacked rows differ from "
                  f"the members' own predict by {worst_own:.3e}")
            bursts = sum(ens.bursts.values())
            print(f"platform: (a) inference job: 1 worker serving the bin "
                  f"{bins[0][:8]}...,{bins[0].split(',')[1][:8]}... on one "
                  f"card, registered stacked={info['stacked']}, "
                  f"staging={info.get('staging')}; {PLATFORM_CHECKED} "
                  f"requests, {n_checked} queries: served = float64 mean of "
                  f"the members' stacked rows, max |diff| {worst:.3e} "
                  f"(tolerance {TOL_ENSEMBLE}); stacked rows against each "
                  f"member's own predict, max |diff| {worst_own:.3e} "
                  f"(tolerance {TOL_STACKED_FF}); {bursts} bursts, "
                  f"{sum(ens.dispatches.values()) / max(1, bursts):.2f} "
                  f"dispatches a burst, modes {ens.bursts}", flush=True)
            check(ens.bursts["fallback"] == ens.bursts["members"] == 0,
                  f"bursts off the stacked path: {ens.bursts}")
            # The buckets a coalesced window of single images reaches,
            # built before it (warmup built bucket 1).
            for b in (2, 4, 8):
                ens.predict_staged_submit(np.zeros(
                    (b, *vds.images.shape[1:]), np.uint8), b)()
            out["window"] = platform_window(
                np, dev, host, vds.images[:AUTOML_WINDOW], card)
            n_st = ens.bursts["stacked"]
            snap = stats_of(host)
            print(f"platform: (a) the window: {n_st} stacked bursts so far, "
                  f"{ens.dispatches['stacked'] / max(1, n_st):.2f} "
                  f"dispatches a burst; the front micro-batched it into "
                  f"{snap['batches']} batches so far "
                  f"({snap['batched_queries'] / max(1, snap['batches']):.2f} "
                  f"queries a batch), stage p50/p95/max ms: fill "
                  f"{[snap['fill'][k] for k in ('p50_ms', 'p95_ms', 'max_ms')]}"
                  f", scatter "
                  f"{[snap['scatter'][k] for k in ('p50_ms', 'p95_ms', 'max_ms')]}"
                  f", gather "
                  f"{[snap['gather'][k] for k in ('p50_ms', 'p95_ms', 'max_ms')]}",
                  flush=True)
            out["routes"] = front_routes(np, p.admin_port, token, host,
                                         inf["id"], vds.images[0], card)

            # (b) A second train job, time-sliced on the same card while
            # (a)'s job serves: (a)'s answers must not move by a bit.
            probes = [vds.images[i] for i in range(SHARED_PROBES)]
            before = dev.predict(host, queries=probes)["predictions"]
            job2 = dev.create_train_job(
                "smoke-shared", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: SHARED_TRIALS},
                train, val)
            svcs2 = [s for s in dev.get_services()
                     if s["service_type"] == "TRAIN"
                     and s["status"] in ("DEPLOYING", "RUNNING")]
            check(bool(svcs2) and all(s["chips"] == [0] for s in svcs2),
                  f"second job's train services {svcs2}")
            t0 = time.perf_counter()
            n_during = 0
            while dev.get_train_job(job2["id"])["status"] == "RUNNING":
                now = dev.predict(host, queries=probes)["predictions"]
                check(now == before, "an answer moved while the second "
                      "job trained on the card")
                n_during += 1
            shared_s = time.perf_counter() - t0
            done2 = dev.get_train_job(job2["id"])
            trials2 = dev.get_trials_of_train_job(job2["id"])
            check(done2["status"] == "STOPPED" and len(trials2) ==
                  SHARED_TRIALS and all(t["status"] == TrialStatus.COMPLETED
                                        for t in trials2),
                  f"second job {done2['status']}: "
                  f"{[t['status'] for t in trials2]}")
            check(n_during > 0, "no request was served while the second "
                  "job trained")
            check(dev.predict(host, queries=probes)["predictions"] == before,
                  "an answer moved after the second job trained")
            print(f"platform: (b) second train job of {SHARED_TRIALS} "
                  f"trials time-sliced on the serving card (chips "
                  f"{svcs2[0]['chips']}): STOPPED in {shared_s:.2f} s, val "
                  f"accuracy {[round(t['score'], 4) for t in trials2]}; "
                  f"{n_during} requests of {SHARED_PROBES} images served "
                  f"meanwhile, every answer bit for bit the one before on "
                  f"{card}", flush=True)
            dev.stop_inference_job(inf["id"])
            group.destroy()
            for m in members:
                m.destroy()
            launches_ab = launch_counts(attn)
            check(launches_ab[:3] == (0, 0, 0),
                  f"(a) and (b) launched K1/K2/K3 {launches_ab[:3]}")

            # (c) The flagship LM, uploaded as model_source.
            tok_train, tok_val = make_synthetic_token_dataset(
                os.path.join(tmp, "tokens"), n_train=1 << 20,
                n_val=1 << 16, vocab_size=FLAGSHIP["vocab_size"], seed=SEED)
            lm = dev.create_model("flagship-lm", TaskType.LANGUAGE_MODELING,
                                  "FlagshipLM", model_source=LM_SOURCE)
            t0 = time.perf_counter()
            job3 = dev.create_train_job(
                "smoke-lm", TaskType.LANGUAGE_MODELING, [lm["id"]],
                {BudgetOption.MODEL_TRIAL_COUNT: 1}, tok_train, tok_val)
            done3 = wait_train(dev, job3["id"])
            lm_train_s = time.perf_counter() - t0
            (trial,) = dev.get_trials_of_train_job(job3["id"])
            check(done3["status"] == "STOPPED"
                  and trial["status"] == TrialStatus.COMPLETED,
                  f"LM job {done3['status']}, trial {trial['status']}")
            k = trial["knobs"]
            check((k["d_model"], k["n_layers"], k["seq_len"],
                   k["vocab_size"], k["batch_size"], k["train_steps"]) ==
                  (2048, 8, 2048, 32768, 8, TRAIN_STEPS),
                  f"the LM trial's knobs {k}")
            train_launches = launch_counts(attn)
            inf3 = dev.create_inference_job(job3["id"], max_models=1)
            host3 = dev.get_inference_job(inf3["id"])["predictor_host"]
            rng = np.random.default_rng(SEED)
            queries = [rng.integers(0, k["vocab_size"], k["seq_len"]).tolist()
                       for _ in range(LM_QUERIES)]
            t0 = time.perf_counter()
            served = dev.predict(host3, queries=queries)["predictions"]
            serve_s = time.perf_counter() - t0
            lm_stats = json.loads(admin_get(
                p.admin_port, f"/inference_jobs/{inf3['id']}/stats", token))
            check(lm_stats["microbatch"] is True
                  and lm_stats["batches"] >= 1
                  and lm_stats["batched_queries"] == LM_QUERIES,
                  f"the LM's /predict did not go through the batcher: "
                  f"{lm_stats}")
            launches = launch_counts(attn)
            direct = TorchTransformerLM(device="cuda", **k)
            direct.load_parameters(p.params.load(trial["params_id"]))
            own = direct.predict(queries)
            direct.destroy()
            check(served == own and all(math.isfinite(x) for x in served),
                  f"served LM scores {served} != direct predict {own}")
            check(all(x > 0 for x in launches[:3]),
                  f"(c) launched K1/K2/K3 {launches[:3]}")
            check(launches[3:] == launches[:3],
                  f"(c) off the wgmma variants: {launches}")
            print(f"platform: (c) FlagshipLM uploaded as model_source "
                  f"(d_model 2048, 8 layers, 16 heads of 128, seq_len 2048, "
                  f"vocab 32768, batch 8, {TRAIN_STEPS} steps): train job "
                  f"STOPPED in {lm_train_s:.2f} s (val token accuracy "
                  f"{trial['score']:.4f}); {LM_QUERIES} queries of "
                  f"{k['seq_len']} ids through POST /predict in "
                  f"{serve_s * 1e3:.1f} ms, scores {[round(x, 4) for x in served]} "
                  f"= a directly built TorchTransformerLM's predict on the "
                  f"same params file, exactly; launches K1 {launches[0]} "
                  f"(training {train_launches[0]}), K2 {launches[1]}, K3 "
                  f"{launches[2]}, all wgmma, on {card}", flush=True)
            print(f"front: (d) the LM's {LM_QUERIES} queries through the "
                  f"micro-batcher (GET /inference_jobs/<id>/stats): "
                  f"{lm_stats['batches']} batch(es), "
                  f"{lm_stats['batched_queries']} queries, coalescing factor "
                  f"{lm_stats['coalescing_factor']}, gather p50 "
                  f"{lm_stats['gather']['p50_ms']} ms; served == direct "
                  f"exactly, K1 {launches[0]} launches, all wgmma, on {card}",
                  flush=True)
            out["lm_front"] = {k: lm_stats[k] for k in (
                "batches", "batched_queries", "coalescing_factor")}
            dev.stop_inference_job(inf3["id"])
        finally:
            p.shutdown()
    phase_s = time.perf_counter() - t_phase
    print(f"platform: phase took {phase_s:.1f} s", flush=True)
    out.update(search_s=search_s, trials_per_hour=tph, ensemble_err=worst,
               shared_s=shared_s, n_during=n_during, lm_train_s=lm_train_s,
               phase_s=phase_s)
    return out, launches[:3]


def trial_warm_starts(meta, trial_id):
    """The tensor counts of a trial's "warm-started N shared tensors"
    log lines."""
    out = []
    for rec in meta.get_trial_logs(trial_id):
        msg = str(rec["record"].get("values", {}).get("msg", ""))
        if msg.startswith("warm-started"):
            out.append(int(msg.split()[1]))
    return out


def epoch_values(meta, trial_id):
    return [x["record"]["values"] for x in meta.get_trial_logs(trial_id)
            if x["record"]["type"] == "values"
            and "epoch" in x["record"]["values"]]


def zoo_densenet(torch, np, card, train, val, tmp):
    """(a) DenseNet-121 at full width trains one epoch on the card."""
    import copy
    import os

    import torch.nn.functional as F

    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model import torch_model
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.model.logger import logger
    from rafiki_torch.models import TorchDenseNet
    from rafiki_torch.store import ParamStore

    ds = load_image_dataset(train)
    vds = load_image_dataset(val)
    first = torch.from_numpy(ds.images[:ZOO_LOSS_IMAGES]).to("cuda")
    first_y = torch.from_numpy(ds.labels[:ZOO_LOSS_IMAGES]).to("cuda")

    def train_mode_loss(m, net):
        net = copy.deepcopy(net).train()
        with torch.no_grad():
            logits = m._logits(net, first.float() / 255.0).float()
        return float(F.cross_entropy(logits, first_y))

    m = TorchDenseNet(device="cuda", **DENSENET_KNOBS)
    loss0 = train_mode_loss(m, m._new_net(ds.n_classes, ds.image_shape))
    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        m.train(train)
        torch.cuda.synchronize()
    finally:
        logger.set_sink(prior)
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    epochs = [r["values"] for r in recs
              if r["type"] == "values" and "epoch" in r["values"]]
    steps = ds.size // DENSENET_KNOBS["batch_size"]
    check(len(epochs) == 1, f"{len(epochs)} epochs logged")
    ep = epochs[0]
    loss1 = train_mode_loss(m, m._net)
    t0 = time.perf_counter()
    acc = m.evaluate(val)
    eval_s = time.perf_counter() - t0
    macs = m._macs(m._net, ds.image_shape)
    check(math.isfinite(ep["loss"]) and loss1 < loss0 and ep["loss"] < loss0,
          f"the loss did not fall: {loss0:.4f} before, epoch mean "
          f"{ep['loss']:.4f}, {loss1:.4f} after")
    check(acc >= ZOO_MIN_ACC, f"DenseNet-121 val accuracy {acc:.4f}")
    sps = ep["steps_per_sec"]
    print(f"zoo: (a) DenseNet-121 (growth 32, blocks 6/12/24/16, CIFAR "
          f"stem, {sum(p.numel() for p in m._net.parameters())} "
          f"parameters), batch 128, lr 0.1, wd 1e-4: one epoch of {steps} "
          f"steps in {train_s:.2f} s (capture included), {sps:.2f} steps/s "
          f"over the epoch, {sps * 128:.1f} images/s, chip_util "
          f"{ep.get('chip_util')} ({2 * macs / 1e9:.4f} GFLOP an image "
          f"forward, {6 * 128 * macs / 1e12:.4f} TFLOP a step, over 989 "
          f"TFLOP/s bf16), peak device memory {peak_gb:.2f} GB; loss on "
          f"{ZOO_LOSS_IMAGES} train images {loss0:.4f} before, epoch mean "
          f"{ep['loss']:.4f}, {loss1:.4f} after; val accuracy {acc:.4f} "
          f"({vds.size} images in {eval_s:.2f} s) on {card}", flush=True)

    # One captured step, profiled.
    net = m._new_net(ds.n_classes, ds.image_shape)
    opt = m.create_optimizer(list(net.parameters()), steps, 1)
    data = torch.from_numpy(ds.images).to("cuda")
    labels = torch.from_numpy(ds.labels).to("cuda")
    runner = torch_model._TrainSteps(m, net, opt, data, labels, steps,
                                     DENSENET_KNOBS["batch_size"])
    runner.new_epoch(np.arange(steps * 128).reshape(steps, 128))
    net.train()
    for _ in range(torch_model.WARMUP_STEPS + 2):
        runner.step()
    check(runner.graph is not None, "the DenseNet step was not captured")
    g0, g1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    g0.record()
    for _ in range(20):
        runner.step()
    g1.record()
    torch.cuda.synchronize()
    step_ms = g0.elapsed_time(g1) / 20
    prof = profile(torch, runner.step, "one captured DenseNet-121 train "
                   "step (batch 128)", card, top=8)
    runner.close()
    del runner, data, labels, net, opt

    # The captured step against the eager step, bit for bit, on a
    # second pair of models of the same knobs.
    small_tr, _ = make_synthetic_image_dataset(
        os.path.join(tmp, "graph"), n_train=ZOO_GRAPH_SET, n_val=128,
        seed=SEED + 1, **{k: v for k, v in ZOO_DATA.items()
                          if k not in ("n_train", "n_val")})
    runs = []
    for warmup in (torch_model.WARMUP_STEPS, 10 ** 9):
        saved = torch_model.WARMUP_STEPS
        torch_model.WARMUP_STEPS = warmup
        try:
            twin = TorchDenseNet(device="cuda", **DENSENET_KNOBS)
            twin.train(small_tr)
        finally:
            torch_model.WARMUP_STEPS = saved
        runs.append(twin.dump_parameters())
        twin.destroy()
    a, b = runs
    check(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a),
          "the captured DenseNet steps differ from the eager steps")
    n_stats = sum(k.startswith("batch_stats/") for k in a)
    print(f"zoo: (a) captured step: {step_ms:.3f} ms a replay (CUDA events, "
          f"20 replays), {128 / step_ms * 1e3:.1f} images/s; "
          f"{ZOO_GRAPH_SET // 128} steps ({torch_model.WARMUP_STEPS} eager, "
          f"then replays) against {ZOO_GRAPH_SET // 128} eager steps on a "
          f"second model: all {len(a)} tensors ({n_stats} BatchNorm "
          f"statistics) bit for bit", flush=True)

    # The card's logits against the CPU's on the same parameters, and the
    # params file read back.
    dumped = m.dump_parameters()
    on_cpu = TorchDenseNet(device="cpu", **DENSENET_KNOBS)
    on_cpu.load_parameters(dumped)
    probes = vds.images[:ZOO_PROBES]
    with torch.no_grad():
        lc = m._logits(m._net, torch.from_numpy(probes).to("cuda").float()
                       / 255.0).float().cpu().numpy()
        lh = on_cpu._logits(on_cpu._net, torch.from_numpy(probes).float()
                            / 255.0).float().numpy()
    diff = float(np.abs(lc - lh).max())
    check(diff <= TOL_ZOO_LOGITS, f"card vs CPU logits: {diff:.4e}")
    store = ParamStore(os.path.join(tmp, "densenet_params"))
    pid = store.save(dumped, session_id="zoo")
    again = TorchDenseNet(device="cuda", **DENSENET_KNOBS)
    again.load_parameters(store.load(pid))
    same = np.array_equal(again.predict_proba(vds.images[:64]),
                          m.predict_proba(vds.images[:64]))
    check(same, "the reloaded DenseNet predicts differently")
    print(f"zoo: (a) card vs CPU logits for {ZOO_PROBES} val images on the "
          f"same parameters: max |diff| {diff:.4e} (max |logit| "
          f"{float(np.abs(lh).max()):.3f}; tolerance {TOL_ZOO_LOGITS}); the "
          f"params file ({len(dumped)} tensors) loaded by load_parameters "
          f"predicts 64 val images bit for bit the same", flush=True)
    for x in (m, on_cpu, again):
        x.destroy()
    store.close()
    return {"train_s": train_s, "steps_per_sec": sps,
            "images_per_sec": sps * 128, "chip_util": ep.get("chip_util"),
            "peak_gb": peak_gb, "val_acc": acc, "step_ms": step_ms,
            "busy_share": (prof[1] / 1e3 / step_ms) if prof else None,
            "logit_diff": diff, "loss": [loss0, ep["loss"], loss1],
            "params": dumped}


def zoo_search(meta, params, model, cls, train, val, n_trials, advisor,
               name):
    """Run one search through ``TrialRunner``; returns its rows in order
    and the search's seconds."""
    from rafiki_torch.constants import (BudgetOption, TaskType,
                                        TrainJobStatus)
    from rafiki_torch.worker import TrialRunner

    budget = {BudgetOption.MODEL_TRIAL_COUNT: n_trials}
    job = meta.create_train_job(model["user_id"], name,
                                TaskType.IMAGE_CLASSIFICATION, budget,
                                train, val, TrainJobStatus.RUNNING)
    sub = meta.create_sub_train_job(job["id"], model["id"], "RUNNING")
    runner = TrialRunner(cls, advisor, train, val, meta, params, sub["id"],
                         model_id=model["id"], budget=budget, device="cuda")
    t0 = time.perf_counter()
    rows = runner.run()
    return job, sorted(rows, key=lambda r: r["no"]), \
        time.perf_counter() - t0


def entropy(np, probs):
    """Summed entropy (nats) of the controller's per-position choices."""
    p = np.clip(probs, 1e-30, 1.0)
    return float(-(probs * np.log(p)).sum())


def zoo_phase(torch, np, attn, card, data_dir=None):
    """BASELINE configs 2 and 3 on the card: (a) DenseNet-121 trains one
    epoch at full width; (b) a Bayes search of DenseNet-121 trials; (c)
    an ENAS search at JaxEnas's sizes; (d) the 2 best ENAS trials behind
    ``POST /predict``; (e) none of K1, K2 and K3 launched. Returns the
    phase's numbers; with ``data_dir`` the image set is made there,
    outlives the phase, and its paths are ``out["data"]``."""
    import os
    import tempfile

    from rafiki_torch.advisor import (BayesOptAdvisor, EnasAdvisor,
                                      make_advisor)
    from rafiki_torch.constants import ParamsType, TaskType, TrialStatus
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import TorchDenseNet, TorchEnas
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class
    from rafiki_torch.worker import InferenceWorker

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    out = {}
    check(load_model_class("rafiki_torch.models.densenet:TorchDenseNet")
          is TorchDenseNet and load_model_class(
              "rafiki_torch.models.enas:TorchEnas") is TorchEnas,
          "the model loader does not resolve the zoo's classes")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train, val = make_synthetic_image_dataset(data_dir or tmp,
                                                  seed=SEED, **ZOO_DATA)
        if data_dir:
            out["data"] = (train, val)
        ds = load_image_dataset(train)
        print(f"zoo: synthetic {ZOO_DATA['name']}-shaped set: {ds.size} "
              f"train and {ZOO_DATA['n_val']} val images of "
              f"{ds.image_shape}, {ds.n_classes} classes, "
              f"{ds.images.nbytes / 1e6:.1f} MB of uint8 train images to "
              f"stage on the card; made in {time.perf_counter() - t0:.2f} s",
              flush=True)

        t0 = time.perf_counter()
        out["densenet"] = zoo_densenet(torch, np, card, train, val, tmp)
        out["densenet"]["check_s"] = time.perf_counter() - t0
        print(f"zoo: (a) took {out['densenet']['check_s']:.1f} s", flush=True)

        meta = MetaStore(os.path.join(tmp, "meta.db"))
        params = ParamStore(os.path.join(tmp, "params"))
        user = meta.create_user("zoo@example.com", "-", "MODEL_DEVELOPER")
        search_train = os.path.join(tmp, "search_train.npz")
        np.savez(search_train, images=ds.images[:ZOO_SEARCH_TRAIN],
                 labels=ds.labels[:ZOO_SEARCH_TRAIN],
                 n_classes=ds.n_classes)
        vds = load_image_dataset(val)
        search_val = os.path.join(tmp, "search_val.npz")
        np.savez(search_val, images=vds.images[:ZOO_SEARCH_VAL],
                 labels=vds.labels[:ZOO_SEARCH_VAL],
                 n_classes=vds.n_classes)
        print(f"zoo: (b) and (c) train on the set's first "
              f"{ZOO_SEARCH_TRAIN} train images and evaluate on its first "
              f"{ZOO_SEARCH_VAL} val images", flush=True)

        # (b) A Bayes search of DenseNet-121 trials.
        t0 = time.perf_counter()
        dn_cls = load_model_class("ZooDenseNet", ZOO_DENSENET_SOURCE)
        dn_model = meta.create_model(user["id"], "densenet",
                                     TaskType.IMAGE_CLASSIFICATION,
                                     "ZooDenseNet", {},
                                     model_source=ZOO_DENSENET_SOURCE)
        advisor = make_advisor(dn_cls.get_knob_config(), seed=SEED,
                               total_trials=BAYES_TRIALS, device="cuda")
        check(isinstance(advisor, BayesOptAdvisor),
              f"make_advisor chose {type(advisor).__name__} for DenseNet")
        _, rows, search_s = zoo_search(meta, params, dn_model, dn_cls,
                                       search_train, search_val,
                                       BAYES_TRIALS, advisor, "zoo-bayes")
        check(len(rows) == BAYES_TRIALS and all(
            r["status"] == TrialStatus.COMPLETED for r in rows),
            f"Bayes trials: {[(r['status'], r.get('error')) for r in rows]}")
        check(len(advisor._y) == BAYES_TRIALS, "the advisor heard "
              f"{len(advisor._y)} scores")
        for r in rows:
            ep = epoch_values(meta, r["id"])
            secs = r["finished_at"] - r["started_at"]
            origin = ("random draw" if r["no"] <= advisor.n_initial
                      else "fitted GP")
            print(f"zoo: (b) trial {r['no']} ({origin}): "
                  f"knobs {json.dumps(r['knobs'])}: {secs:.2f} s, "
                  f"{ep[-1]['steps_per_sec']:.2f} steps/s, chip_util "
                  f"{ep[-1].get('chip_util')}, epoch loss "
                  f"{ep[-1]['loss']:.4f}, val accuracy {r['score']:.4f}",
                  flush=True)
        check(max(r["score"] for r in rows) >= ZOO_MIN_ACC,
              f"no Bayes trial reached {ZOO_MIN_ACC}")
        print(f"zoo: (b) Bayes search (make_advisor chose "
              f"{type(advisor).__name__}, seed {SEED}, n_initial "
              f"{advisor.n_initial}) of {BAYES_TRIALS} DenseNet-121 trials "
              f"(arch and max_epochs 1 pinned) in {search_s:.2f} s: "
              f"{BAYES_TRIALS * 3600 / search_s:.1f} trials/hour on {card}; "
              f"check took {time.perf_counter() - t0:.1f} s", flush=True)
        out["bayes"] = {"search_s": search_s,
                        "trials_per_hour": BAYES_TRIALS * 3600 / search_s,
                        "scores": [r["score"] for r in rows]}

        # (c) An ENAS search at JaxEnas's sizes.
        t0 = time.perf_counter()
        en_cls = load_model_class("ZooEnas", ZOO_ENAS_SOURCE)
        en_model = meta.create_model(user["id"], "enas",
                                     TaskType.IMAGE_CLASSIFICATION,
                                     "ZooEnas", {},
                                     model_source=ZOO_ENAS_SOURCE)
        advisor = make_advisor(en_cls.get_knob_config(), seed=SEED,
                               total_trials=ENAS_TRIALS, device="cuda")
        check(isinstance(advisor, EnasAdvisor),
              f"make_advisor chose {type(advisor).__name__} for ENAS")
        h0 = entropy(np, advisor.arch_probs())
        job, rows, search_s = zoo_search(meta, params, en_model, en_cls,
                                         search_train, search_val,
                                         ENAS_TRIALS, advisor, "zoo-enas")
        h1 = entropy(np, advisor.arch_probs())
        check(len(rows) == ENAS_TRIALS and all(
            r["status"] == TrialStatus.COMPLETED for r in rows),
            f"ENAS trials: {[(r['status'], r.get('error')) for r in rows]}")
        search = [r for r in rows if r["knobs"]["share_params"]]
        final = [r for r in rows if not r["knobs"]["share_params"]]
        check(len(search) == ENAS_TRIALS - 1 and len(final) == 1
              and final[0]["no"] == ENAS_TRIALS,
              f"phases: {[r['knobs']['share_params'] for r in rows]}")
        n_super = len(params.load(search[0]["params_id"])) - 2
        n_single = len(params.load(final[0]["params_id"])) - 2
        for r in rows:
            warm = trial_warm_starts(meta, r["id"])
            phase = "search" if r["knobs"]["share_params"] else "final"
            secs = r["finished_at"] - r["started_at"]
            ep = epoch_values(meta, r["id"])
            net = ("supernet 3 cells of 16" if phase == "search"
                   else "single path 6 cells of 32")
            print(f"zoo: (c) trial {r['no']} ({phase}, {net}): "
                  f"arch {r['knobs']['arch']}, warm-started "
                  f"{warm[0] if warm else 0} tensors, {secs:.2f} s, "
                  f"{ep[-1]['steps_per_sec']:.2f} steps/s, val accuracy "
                  f"{r['score']:.4f}", flush=True)
            if phase == "search" and r["no"] > 1:
                check(warm == [n_super], f"search trial {r['no']} "
                      f"warm-started {warm} of {n_super} tensors")
            if phase == "final":
                check(warm == [], f"the final trial warm-started {warm}")
        best = max(search, key=lambda r: r["score"])
        check(final[0]["knobs"]["arch"] == best["knobs"]["arch"],
              "the final trial did not retrain the best search arch")
        check(max(r["score"] for r in rows) > 1.5 / ZOO_DATA["n_classes"],
              "every ENAS trial at chance")
        print(f"zoo: (c) ENAS search (make_advisor chose "
              f"{type(advisor).__name__}, seed {SEED}, {ENAS_TRIALS} trials: "
              f"{len(search)} search on the masked supernet with "
              f"{ParamsType.GLOBAL_RECENT} warm starts of all {n_super} "
              f"tensors, 1 final retraining trial {best['no']}'s arch from "
              f"scratch on the single path, {n_single} tensors) in "
              f"{search_s:.2f} s: {ENAS_TRIALS * 3600 / search_s:.1f} "
              f"trials/hour; controller entropy {h0:.4f} nats before, "
              f"{h1:.4f} after; check took {time.perf_counter() - t0:.1f} s "
              f"on {card}", flush=True)
        out["enas"] = {"search_s": search_s,
                       "trials_per_hour": ENAS_TRIALS * 3600 / search_s,
                       "entropy": [h0, h1],
                       "scores": [r["score"] for r in rows]}

        # (d) The 2 best ENAS trials behind POST /predict.
        t0 = time.perf_counter()
        vds = load_image_dataset(val)
        out["val"] = (vds.images[:ENSEMBLE_VAL], vds.labels[:ENSEMBLE_VAL])
        top = meta.get_best_trials_of_train_job(job["id"],
                                                max_count=ZOO_DEPLOY)
        check(len(top) == ZOO_DEPLOY, f"{len(top)} ENAS trials to deploy")
        workers = [InferenceWorker(en_cls, t["knobs"],
                                   params.load(t["params_id"]),
                                   device="cuda").start() for t in top]
        app = PredictorService(workers, device="cuda").start()
        try:
            worst, n_checked = 0.0, 0
            for i in range(5):
                imgs = vds.images[8 * i:8 * i + 1 + i]
                floats = (imgs.astype(np.float32) / 255.0).tolist()
                body = ({"query": floats[0]} if i % 2 == 0
                        else {"queries": floats})
                status, resp, _ = post(app.url + "/predict", body)
                check(status == 200, f"/predict answered {status}")
                served = np.asarray([resp["prediction"]] if i % 2 == 0
                                    else resp["predictions"])
                qs = floats[:1] if i % 2 == 0 else floats
                own = np.mean(np.asarray(
                    [w.predict(qs, timeout=60) for w in workers],
                    np.float64), axis=0)
                err = float(np.abs(served - own).max())
                worst = max(worst, err)
                check(err <= TOL_ENSEMBLE, f"served differs from the "
                      f"members' mean by {err:.3e}")
                n_checked += len(qs)
            print(f"zoo: (d) the {ZOO_DEPLOY} best ENAS trials "
                  f"({[t['no'] for t in top]}, val accuracy "
                  f"{[round(t['score'], 4) for t in top]}) deployed; 5 POST "
                  f"/predict requests, {n_checked} queries: served = float64 "
                  f"mean of the members' own predict, max |diff| "
                  f"{worst:.3e} (tolerance {TOL_ENSEMBLE})", flush=True)
            out["window"] = automl_window(np, app.url,
                                          vds.images[:AUTOML_WINDOW], card,
                                          tag="zoo: (d)", deployed=ZOO_DEPLOY)
        finally:
            app.stop()
            for w in workers:
                w.stop()
        print(f"zoo: (d) took {time.perf_counter() - t0:.1f} s", flush=True)
        params.close()
        meta.close()

    # (e) The phase ran none of the attention kernels.
    launches = launch_counts(attn)
    check(launches[:3] == (0, 0, 0),
          f"the zoo phase launched K1/K2/K3 {launches[:3]}")
    phase_s = time.perf_counter() - t_phase
    print(f"zoo: (e) K1, K2 and K3 launched 0 times in the phase; phase "
          f"took {phase_s:.1f} s", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def stacked_rows(np, group, imgs):
    """A stacked group's ``(M, n, n_classes)`` rows for the ``n`` images
    ``imgs``: one staged dispatch at their bucket."""
    n = imgs.shape[0]
    buf = np.zeros((group.predict_bucket(n, imgs.dtype), *imgs.shape[1:]),
                   imgs.dtype)
    buf[:n] = imgs
    dev, _ = group.staged_submit(buf, n)
    return dev[:, :n].cpu().numpy()


def member_rows(np, model, imgs):
    """One member's own ``(n, n_classes)`` rows at the same bucket."""
    n = imgs.shape[0]
    buf = np.zeros((model.predict_bucket(n, imgs.dtype),
                    *imgs.shape[1:]), imgs.dtype)
    buf[:n] = imgs
    dev, _ = model._dispatch_bucket(buf, n)
    return dev[:n].cpu().numpy()


def in_bursts(np, fn, imgs, size):
    """``fn`` over ``imgs`` in bursts of ``size``, joined on the rows."""
    return np.concatenate([fn(imgs[s:s + size])
                           for s in range(0, imgs.shape[0], size)], axis=-2)


def seeded_densenet(np, seed):
    """A DenseNet-121 parameter file from ``seed`` (random weights)."""
    from rafiki_torch.model.bridge import dense_to_jax
    from rafiki_torch.models import TorchDenseNet

    net = TorchDenseNet(device="cpu", seed=seed,
                        **DENSENET_KNOBS).create_module(
                            ZOO_DATA["n_classes"], ZOO_DATA["image_shape"])
    p = dense_to_jax(net.state_dict())
    p["_meta/n_classes"] = np.asarray(ZOO_DATA["n_classes"])
    p["_meta/image_shape"] = np.asarray(ZOO_DATA["image_shape"])
    return p


class EnsembleDeploy:
    """Bins of trials in a meta and param store under ``tmp``, each
    served by a ``BusInferenceWorker`` on the card over one
    ``MemoryBus``, behind its own ``PredictorService``."""

    def __init__(self, tmp):
        import os

        from rafiki_torch.bus import MemoryBus
        from rafiki_torch.store import MetaStore, ParamStore

        self.meta = MetaStore(os.path.join(tmp, "meta.db"))
        self.params = ParamStore(os.path.join(tmp, "params"))
        self.bus = MemoryBus()
        self.user = self.meta.create_user("ens@example.com", "-",
                                          "MODEL_DEVELOPER")
        self.workers, self.fronts = [], []

    def bin(self, model_class, trials):
        """Trials ``[(knobs, params)]`` of one model -> the bin's id."""
        model = self.meta.create_model(self.user["id"], model_class,
                                       "IMAGE_CLASSIFICATION", model_class,
                                       {})
        self.job = self.meta.create_train_job(
            self.user["id"], model_class, "IMAGE_CLASSIFICATION", {}, "-",
            "-", "STOPPED")
        sub = self.meta.create_sub_train_job(self.job["id"], model["id"],
                                             "STOPPED")
        ids = []
        for i, (knobs, p) in enumerate(trials):
            t = self.meta.create_trial(sub["id"], model["id"], i + 1,
                                       "RUNNING", knobs=knobs)
            self.meta.mark_trial_completed(
                t["id"], 0.5, self.params.save(p, session_id="ens"))
            ids.append(t["id"])
        return ",".join(ids)

    def serve(self, trial_ids, env):
        """A worker for the bin, built under the serving variables
        ``env``, and its predictor: ``(worker, host, registration)``."""
        inf = self.meta.create_inference_job(self.user["id"],
                                             self.job["id"], "RUNNING")
        worker, info = self.replica(trial_ids, inf["id"], env)
        app = self.front(inf["id"])
        return worker, f"{app.host}:{app.port}", info

    def replica(self, trial_ids, inf_id, env=None):
        """One more worker for the bin in the inference job ``inf_id``,
        built under the serving variables ``env``, once registered:
        ``(worker, registration)``."""
        import os

        from rafiki_torch.cache import Cache
        from rafiki_torch.worker.inference import BusInferenceWorker

        env = env or {}
        svc = self.meta.create_service("INFERENCE", "DEPLOYING")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            worker = BusInferenceWorker(svc["id"], inf_id, trial_ids,
                                        self.meta, self.params, self.bus,
                                        device="cuda")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        worker.start()
        self.workers.append(worker)
        cache = Cache(self.bus)
        deadline = time.monotonic() + 300
        while svc["id"] not in cache.running_workers(inf_id):
            check(worker.running and time.monotonic() < deadline,
                  f"the worker of {trial_ids[:17]}... did not register")
            time.sleep(0.05)
        return worker, cache.running_worker_info(inf_id)[svc["id"]]

    def front(self, inf_id, **knobs):
        """A started ``PredictorService`` of the job ``inf_id`` with the
        serving keywords ``knobs``."""
        from rafiki_torch.predictor import PredictorService

        psvc = self.meta.create_service("PREDICT", "DEPLOYING")
        app = PredictorService.for_job(psvc["id"], inf_id, self.meta,
                                       self.bus, **knobs).start()
        self.fronts.append(app)
        return app

    def close(self):
        # The fronts first: they fail any request still waiting.
        for app in self.fronts:
            app.stop()
        for worker in self.workers:
            worker.stop(join_timeout=60)
            check(not worker.running, "a worker did not stop")
        self.params.close()
        self.meta.close()


def served_rows(worker):
    """Count the rows ``worker`` answers, by wrapping its reply call:
    ``{"rows": n, "replies": n}``."""
    counts = {"rows": 0, "replies": 0}
    send = worker.cache.send_prediction_batch

    def counted(batch_id, worker_id, predictions, **kw):
        counts["rows"] += len(predictions)
        counts["replies"] += 1
        return send(batch_id, worker_id, predictions, **kw)

    worker.cache.send_prediction_batch = counted
    return counts


def stats_of(host):
    """A predictor's ``GET /stats``."""
    with urllib.request.urlopen(f"http://{host}/stats", timeout=60) as r:
        return json.loads(r.read())


def post_raw(url, body):
    """One raw ``POST``: ``(status, Retry-After, payload)``."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Retry-After"), json.loads(
                r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def front_phase(torch, np, card, dep, worker, trial_ids, imgs):
    """The serving front (``PredictorService.for_job``'s defaults) in
    front of the stacked DenseNet-121 bin's worker: (a) the window with
    micro-batching on and off; (b) a second replica of the bin, both
    taking shards, each query answered by one of them, then one replica
    hung mid-window (registered, not serving): every request answered,
    its shards resubmitted and it quarantined; (c) backpressure: a
    front with ``queue_cap`` 64 and bursts of raw clients, 429 with
    ``Retry-After``, no 5xx, ``/stats`` ``rejected`` = the 429s the
    clients counted, and a ``Client.predict`` answered after its
    retry. Returns the numbers."""
    import threading

    from rafiki_torch.cache import encode_payload
    from rafiki_torch.client import Client

    t_phase = time.perf_counter()
    out = {}
    client = Client()
    ens, inf_id = worker.model, worker.inference_job_id
    window = imgs[:ENSEMBLE_WINDOW]
    # The worker's own rows, each image alone (bucket 1), as served: the
    # members' float64 mean.
    own = in_bursts(np, lambda x: stacked_rows(np, ens.stacked, x), window,
                    1).astype(np.float64).mean(0)

    # (a) Micro-batching on, then off, on the same worker.
    wins = {}
    for on in (True, False):
        app = dep.front(inf_id, microbatch=on)
        host = f"{app.host}:{app.port}"
        mode = "on" if on else "off"
        reset_counts(ens)
        win = platform_window(
            np, client, host, window, card, tag=f"front: (a) microbatch "
            f"{mode}:", what=f"one worker serving the {ENSEMBLE_MEMBERS}-"
            f"member DenseNet-121 bin, stacked")
        snap = stats_of(host)
        bursts = sum(ens.bursts.values())
        err = float(np.abs(win["answers"] - own).max())
        check(snap["microbatch"] is on
              and snap["requests"] == ENSEMBLE_WINDOW
              and snap["rejected"] == 0
              and (snap["batches"] > 0) is on, f"front /stats {snap}")
        check(ens.bursts["stacked"] == bursts > 0,
              f"window ran bursts as {ens.bursts}")
        check(err <= TOL_STACKED_DENSENET, f"microbatch {mode}: served "
              f"differs from the worker's own rows by {err:.3e}")
        batches = snap["batches"]
        print(f"front: (a) microbatch {mode}: /stats batches {batches}, "
              f"{snap['batched_queries'] / max(1, batches):.2f} queries a "
              f"batch (coalescing factor {snap['coalescing_factor']}), "
              f"fill p50 {snap['fill']['p50_ms']} ms, gather p50 "
              f"{snap['gather']['p50_ms']} ms; the worker ran {bursts} "
              f"bursts, {ENSEMBLE_WINDOW / bursts:.2f} queries a burst; "
              f"served against the worker's own rows (each image at bucket "
              f"1): max |diff| {err:.3e} (tolerance {TOL_STACKED_DENSENET}) "
              f"on {card}", flush=True)
        wins[mode] = dict({k: v for k, v in win.items() if k != "answers"},
                          batches=batches, bursts=bursts,
                          queries_a_batch=snap["batched_queries"]
                          / max(1, batches),
                          queries_a_burst=ENSEMBLE_WINDOW / bursts,
                          answers=win["answers"], err=err)
    on_off = float(np.abs(wins["on"]["answers"]
                          - wins["off"]["answers"]).max())
    print(f"front: (a) the two windows' answers: max |diff| {on_off:.3e}; "
          f"queries/s on/off {wins['on']['qps'] / wins['off']['qps']:.3f}",
          flush=True)

    # (b) A second replica of the bin: the front shards each batch over
    # both.
    t0 = time.perf_counter()
    rep, info = dep.replica(trial_ids, inf_id)
    check(info["stacked"] is True, f"the replica registered {info}")
    for b in (2, 4, 8):
        rep.model.predict_staged_submit(
            np.zeros((b, *imgs.shape[1:]), np.uint8), b)()
    rep_s = time.perf_counter() - t0
    rows = {"worker": served_rows(worker), "replica": served_rows(rep)}
    app = dep.front(inf_id)
    host, pred = f"{app.host}:{app.port}", app.predictor
    check(app.batcher is not None and pred.shard_replicas,
          "the default front does not micro-batch and shard")
    win = platform_window(np, client, host, window, card,
                          tag="front: (b) two replicas:",
                          what="two workers of the stacked DenseNet-121 bin")
    snap = stats_of(host)
    replies = {k: dict(v) for k, v in rows.items()}
    check(all(v["rows"] > 0 for v in replies.values())
          and sum(v["rows"] for v in replies.values()) == ENSEMBLE_WINDOW,
          f"rows answered by each replica {replies}")
    check(all(pred._m_replica.count(service=pred.service,
                                    worker=w.service_id[:8]) > 0
              for w in (worker, rep)), "a replica took no shard")
    shards = pred._m_shards.value(service=pred.service)
    err_one = float(np.abs(win["answers"] - wins["on"]["answers"]).max())
    err_own = float(np.abs(win["answers"] - own).max())
    check(err_own <= TOL_STACKED_DENSENET,
          f"two replicas: served differs from the worker's own rows by "
          f"{err_own:.3e}")
    print(f"front: (b) replica loaded and warmed in {rep_s:.2f} s; "
          f"{shards:.0f} shards over {snap['batches']} batches; rows "
          f"answered: worker {replies['worker']['rows']} in "
          f"{replies['worker']['replies']} replies, replica "
          f"{replies['replica']['rows']} in {replies['replica']['replies']}"
          f" (sum {ENSEMBLE_WINDOW}: one vote a query); against the one-"
          f"replica window max |diff| {err_one:.3e}, against the worker's "
          f"own rows {err_own:.3e} (tolerance {TOL_STACKED_DENSENET}) on "
          f"{card}", flush=True)
    out["sharded"] = dict({k: v for k, v in win.items() if k != "answers"},
                          shards=shards, rows=replies, err=err_own)

    # (b) The replica's serving loop stops mid-window; it stays
    # registered.
    hung = threading.Event()
    pop = rep.cache.pop_queries

    def stalled(worker_id, max_items=0, timeout=1.0):
        if hung.is_set():
            time.sleep(timeout)
            return []
        return pop(worker_id, max_items=max_items, timeout=timeout)

    class Hanging(Client):
        n = 0

        def predict(self, *a, **kw):
            Hanging.n += 1
            if Hanging.n == ENSEMBLE_WINDOW // 4:
                hung.set()
            return super().predict(*a, **kw)

    rep.cache.pop_queries = stalled
    win = platform_window(np, Hanging(), host, window, card,
                          tag="front: (b) one replica hung mid-window:",
                          what="two workers, one stopping at request "
                               f"{ENSEMBLE_WINDOW // 4}")
    resubmits = pred._m_resubmits.value(service=pred.service)
    quarantines = pred._m_quarantines.value(service=pred.service)
    err = float(np.abs(win["answers"] - own).max())
    check(hung.is_set() and resubmits > 0 and quarantines > 0,
          f"resubmits {resubmits}, quarantines {quarantines}")
    check(err <= TOL_STACKED_DENSENET, f"hung replica: served differs "
          f"from the worker's own rows by {err:.3e}")
    check(rep.service_id in pred.workers(), "the hung replica unregistered")
    print(f"front: (b) every one of {ENSEMBLE_WINDOW} requests answered; "
          f"shard resubmits {resubmits:.0f}, quarantines {quarantines:.0f} "
          f"(rafiki_tpu_serving_shard_resubmits_total, "
          f"_replica_quarantines_total); served against the worker's own "
          f"rows max |diff| {err:.3e} on {card}", flush=True)
    out["hung"] = dict({k: v for k, v in win.items() if k != "answers"},
                       resubmits=resubmits, quarantines=quarantines)
    rep.cache.pop_queries = pop
    rep.stop(join_timeout=60)
    check(not rep.running and rep.service_id not in pred.workers(),
          "the replica did not stop")

    # (c) Backpressure: queue_cap 64, one batch of 16 in flight, bursts
    # of raw clients posting 16 images each.
    ens.predict_staged_submit(np.zeros((FRONT_BATCH, *imgs.shape[1:]),
                                       np.uint8), FRONT_BATCH)()
    app = dep.front(inf_id, queue_cap=FRONT_CAP, max_batch=FRONT_BATCH,
                    max_inflight=1)
    host = f"{app.host}:{app.port}"
    batch = list(imgs[:FRONT_BATCH])
    body = json.dumps({"queries": [encode_payload(x)
                                   for x in batch]}).encode()
    want = stacked_rows(np, ens.stacked, imgs[:FRONT_BATCH]).astype(
        np.float64).mean(0)

    # The worker holds its queue while a burst fills the front, and the
    # Client posts once a raw client has met a 429: its first request
    # meets a full queue whatever the host's timing, and its 429
    # releases the worker before its retry.
    held = threading.Event()
    pop = worker.cache.pop_queries

    def holding(worker_id, max_items=0, timeout=1.0):
        if held.is_set():
            time.sleep(0.01)
            return []
        return pop(worker_id, max_items=max_items, timeout=timeout)

    class Counting(Client):
        statuses = []

        def _send(self, *a, **kw):
            status, payload, hdrs = super()._send(*a, **kw)
            Counting.statuses.append(status)
            if status == 429:
                held.clear()
            return status, payload, hdrs

    codes, answers, worst = [], [], 0.0
    worker.cache.pop_queries = holding
    try:
        for attempt in range(3):
            barrier = threading.Barrier(FRONT_BURST + 1)
            got = []
            held.set()

            def raw():
                barrier.wait()
                got.append(post_raw(f"http://{host}/predict", body))

            def counted():
                barrier.wait()
                t_wait = time.monotonic() + 60
                while (held.is_set() and time.monotonic() < t_wait
                       and not any(c == 429 for c, _, _ in list(got))):
                    time.sleep(0.005)
                answers.append(Counting(retries=3).predict(
                    host, queries=batch)["predictions"])

            threads = [threading.Thread(target=raw)
                       for _ in range(FRONT_BURST)]
            threads.append(threading.Thread(target=counted))
            t0 = time.perf_counter()
            [t.start() for t in threads]
            [t.join(timeout=300) for t in threads]
            burst_s = time.perf_counter() - t0
            held.clear()
            codes.extend(got)
            check(len(got) == FRONT_BURST and answers,
                  "a burst's client did not return")
            for status, _, payload in got:
                if status == 200:
                    worst = max(worst, float(np.abs(np.asarray(
                        payload["predictions"]) - want).max()))
            if 429 in Counting.statuses:
                break
    finally:
        held.clear()
        worker.cache.pop_queries = pop
    statuses = [c for c, _, _ in codes]
    n429 = statuses.count(429) + Counting.statuses.count(429)
    snap = stats_of(host)
    client_err = float(np.abs(np.asarray(answers[-1]) - want).max())
    check(set(statuses) <= {200, 429} and statuses.count(429) > 0,
          f"burst statuses {sorted(set(statuses))}")
    check(all(ra is not None and int(ra) >= 1
              for c, ra, _ in codes if c == 429), "a 429 without Retry-After")
    check(snap["rejected"] == n429, f"/stats rejected {snap['rejected']} "
          f"against {n429} 429s counted by the clients")
    check(429 in Counting.statuses and Counting.statuses[-1] == 200,
          f"the Client's statuses {Counting.statuses}")
    check(worst <= TOL_ENSEMBLE and client_err <= TOL_ENSEMBLE,
          f"answers of the burst differ from the stacked rows by "
          f"{max(worst, client_err):.3e}")
    print(f"front: (c) queue_cap {FRONT_CAP}, max_batch {FRONT_BATCH}, one "
          f"batch in flight: {attempt + 1} burst(s) of {FRONT_BURST} raw "
          f"clients and one Client, {FRONT_BATCH} images a request (the last"
          f" {burst_s:.2f} s): {statuses.count(200)} answered, "
          f"{statuses.count(429)} 429 with Retry-After "
          f"{sorted({ra for c, ra, _ in codes if c == 429})}, no 5xx; /stats "
          f"rejected {snap['rejected']} = the clients' 429s {n429} "
          f"(queue depth peak {snap['queue_depth_peak']}); the Client's "
          f"statuses {Counting.statuses}, answered after its Retry-After; "
          f"answers against the stacked rows at bucket {FRONT_BATCH}: max "
          f"|diff| {max(worst, client_err):.3e} (tolerance {TOL_ENSEMBLE}) "
          f"on {card}", flush=True)
    out.update(windows={k: {q: v for q, v in w.items() if q != "answers"}
                        for k, w in wins.items()},
               on_off_diff=on_off,
               backpressure={"answered": statuses.count(200),
                             "rejected": n429, "bursts": attempt + 1},
               phase_s=time.perf_counter() - t_phase)
    print(f"front: (a)-(c) took {out['phase_s']:.1f} s", flush=True)
    return out


def reset_counts(ens):
    for counts in (ens.bursts, ens.dispatches):
        for mode in counts:
            counts[mode] = 0


def ensemble_phase(torch, np, attn, card, automl, zoo):
    """BASELINE config 4 as the reference serves a bin. (a) 4
    DenseNet-121 members in one bin through BusInferenceWorker, the
    predictor and the Client: a window with stacking on and one with it
    off, each member's rows both ways, one burst's device time; (b) int8
    serving: the automl phase's FeedForward trials stacked under
    ``RAFIKI_TPU_SERVING_QUANT=int8`` (``int8_mm`` exact at every
    bucket, |Δp| and val accuracy against f32), and DenseNet-121 on the
    generic fallback (argmax agreement and val accuracy against f32, peak
    memory); (c) a restack of member 2, read by the captured graphs with
    no recapture; (d) none of K1, K2 and K3 launched. Returns the phase's
    numbers and K1-K3 launches."""
    import tempfile

    from rafiki_torch.client import Client
    from rafiki_torch.model.torch_model import (int8_mm, normalised,
                                               probabilities, stack_members)
    from rafiki_torch.models import TorchDenseNet, TorchFeedForward
    from rafiki_torch.observe import wire

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    out = {}
    imgs, labels = zoo["val"]
    # Member 0 is the zoo phase's trained DenseNet-121; 1-3 from seeds.
    dn_params = [zoo["densenet"]["params"]] + [
        seeded_densenet(np, s) for s in range(1, ENSEMBLE_MEMBERS)]
    client = Client()
    with tempfile.TemporaryDirectory() as tmp:
        dep = EnsembleDeploy(tmp)
        try:
            dn_bin = dep.bin("rafiki_torch.models.densenet:TorchDenseNet",
                             [(ENSEMBLE_KNOBS, p) for p in dn_params])
            # (a) The bin with stacking on, then off.
            wins, ens_of, hosts, workers_of = {}, {}, {}, {}
            for mode, env in (("stacked", {}), ("members", {
                    wire.STACKED_ENV: "off"})):
                t0 = time.perf_counter()
                worker, host, info = dep.serve(dn_bin, env)
                ens = worker.model
                ens_of[mode], hosts[mode] = ens, host
                workers_of[mode] = worker
                check(info["stacked"] is (mode == "stacked"),
                      f"registration {info}")
                load_s = time.perf_counter() - t0
                # The buckets a window of single images reaches, built
                # before it (warmup built bucket 1).
                for b in (2, 4, 8):
                    ens.predict_staged_submit(
                        np.zeros((b, *imgs.shape[1:]), np.uint8), b)()
                check(ens.bursts[mode] == 3 and ens.dispatches[mode] == 3 * (
                    1 if mode == "stacked" else ENSEMBLE_MEMBERS),
                      f"the bursts that built buckets 2, 4 and 8 ran as "
                      f"{ens.bursts}, dispatches {ens.dispatches}")
                reset_counts(ens)
                if mode == "stacked":
                    worst = 0.0
                    for n in (1, 5):
                        served = client.predict(host, queries=list(imgs[:n]))[
                            "predictions"]
                        rows = stacked_rows(np, ens.stacked, imgs[:n])
                        worst = max(worst, float(np.abs(
                            np.asarray(served)
                            - rows.astype(np.float64).mean(0)).max()))
                    check(worst <= TOL_ENSEMBLE, f"served differs from the "
                          f"members' stacked mean by {worst:.3e}")
                    out["served_err"] = worst
                    reset_counts(ens)
                win = platform_window(
                    np, client, host, imgs[:ENSEMBLE_WINDOW], card,
                    tag=f"ensemble: (a) {mode}:",
                    what=f"one worker serving a {ENSEMBLE_MEMBERS}-member "
                         f"DenseNet-121 bin ({mode})")
                bursts = sum(ens.bursts.values())
                per_burst = sum(ens.dispatches.values()) / max(1, bursts)
                check(ens.bursts[mode] == bursts > 0,
                      f"{mode} window ran bursts as {ens.bursts}")
                check(per_burst == (1 if mode == "stacked"
                                    else ENSEMBLE_MEMBERS),
                      f"{per_burst} dispatches a burst ({mode})")
                print(f"ensemble: (a) {mode}: registered stacked="
                      f"{info['stacked']}, staging={info['staging']}, "
                      f"loaded and warmed in {load_s:.2f} s; the window ran "
                      f"{bursts} bursts ({ENSEMBLE_WINDOW / bursts:.2f} "
                      f"queries a burst), {per_burst:.2f} dispatches a "
                      f"burst, modes {ens.bursts}", flush=True)
                wins[mode] = win
                if mode == "stacked":
                    print(f"ensemble: (a) 2 checked requests (1 and 5 "
                          f"images): served = float64 mean of the members' "
                          f"stacked rows, max |diff| {worst:.3e} "
                          f"(tolerance {TOL_ENSEMBLE})", flush=True)
            out["front"] = front_phase(torch, np, card, dep,
                                       workers_of["stacked"], dn_bin, imgs)
            st, per = ens_of["stacked"].stacked, ens_of["members"].models
            # Each member's rows, stacked and on its own, over the
            # window's images in bursts of 8.
            window = imgs[:ENSEMBLE_WINDOW]
            rows_st = in_bursts(np, lambda x: stacked_rows(np, st, x),
                                window, 8)
            rows_pm = np.stack([in_bursts(
                np, lambda x, m=m: member_rows(np, m, x), window, 8)
                for m in per])
            dp = np.abs(rows_st - rows_pm).max(axis=(1, 2))
            served_dp = float(np.abs(wins["stacked"]["answers"]
                                     - wins["members"]["answers"]).max())
            same_top = float((rows_st.argmax(-1)
                              == rows_pm.argmax(-1)).mean())
            check(float(dp.max()) <= TOL_STACKED_DENSENET,
                  f"stacked rows differ from per-member by {dp}")
            print(f"ensemble: (a) each member's max |dp| stacked against "
                  f"its own rows over the window's {ENSEMBLE_WINDOW} images "
                  f"in bursts of 8: {[float(x) for x in dp]} (tolerance "
                  f"{TOL_STACKED_DENSENET}); the two windows' served "
                  f"answers: max |diff| {served_dp:.3e}; argmax agreement "
                  f"{same_top:.4f}", flush=True)
            # One burst's device time (CUDA events) at each bucket: one
            # stacked replay, the 4 members' replays, and the eager
            # per-member forward the port ran before stacking.
            times = {}
            for b in ENSEMBLE_BUCKETS:
                x = imgs[:b]
                stacked_rows(np, st, x)
                for m in per:
                    member_rows(np, m, x)
                runner = st._runners.runners[(b, True, None)]
                runners = [m._runners.runners[(b, True, None)] for m in per]
                xd = torch.from_numpy(x).to("cuda")

                def eager():
                    with torch.no_grad():
                        for m in per:
                            probabilities(m._logits(m._net,
                                                    normalised(xd, True)))

                fns = {"stacked": runner.graph.replay,
                       "members": lambda: [r.graph.replay()
                                           for r in runners],
                       "eager": eager}
                runs = {k: [] for k in fns}
                n = 20 if b < 512 else 5
                for k in ("stacked", "members", "eager", "eager", "members",
                          "stacked"):
                    runs[k].append(time_ms(torch, fns[k], n))
                times[b] = {k: sum(v) / len(v) for k, v in runs.items()}
                print(f"ensemble: (a) one burst at bucket {b}: one stacked "
                      f"replay {times[b]['stacked']:.3f} ms, "
                      f"{ENSEMBLE_MEMBERS} per-member replays "
                      f"{times[b]['members']:.3f} ms, eager per-member "
                      f"{times[b]['eager']:.3f} ms (CUDA events, {n} bursts "
                      f"each, in turns) on {card}", flush=True)
                if b == ENSEMBLE_BUCKETS[-1]:
                    for k in ("stacked", "members"):
                        profile(torch, fns[k], f"one {k} burst at bucket "
                                f"{b}", card, top=6)

            # (c) Restack member 2 in place.
            t0 = time.perf_counter()
            incoming = TorchDenseNet(device="cuda", **ENSEMBLE_KNOBS)
            incoming.load_parameters(seeded_densenet(np, ENSEMBLE_MEMBERS))
            x = imgs[:17]
            before = stacked_rows(np, st, x)
            captures = st.captures
            ens_of["stacked"].replace_member(2, incoming)
            after = stacked_rows(np, st, x)
            keep = [i for i in range(ENSEMBLE_MEMBERS) if i != 2]
            own = member_rows(np, incoming, x)
            new_dp = float(np.abs(after[2] - own).max())
            fresh = stack_members(list(ens_of["stacked"].models))
            same_fresh = np.array_equal(stacked_rows(np, fresh, x), after)
            fresh.destroy()
            check(st.captures == captures, f"the restack recaptured: "
                  f"{captures} -> {st.captures} graphs")
            check(np.array_equal(after[keep], before[keep]),
                  "the restack moved another member's rows")
            check(not np.array_equal(after[2], before[2])
                  and new_dp <= TOL_STACKED_DENSENET,
                  f"member 2 after the restack: |dp| {new_dp:.3e} from the "
                  f"incoming model's own rows")
            check(same_fresh, "the restacked group differs from a group "
                  "stacked afresh on the same members")
            served = client.predict(hosts["stacked"],
                                    queries=list(x))["predictions"]
            err = float(np.abs(np.asarray(served)
                               - after.astype(np.float64).mean(0)).max())
            check(err <= TOL_ENSEMBLE, f"served after the restack: {err:.3e}")
            print(f"ensemble: (c) replace_member(2, a DenseNet-121 from seed "
                  f"{ENSEMBLE_MEMBERS}) in {time.perf_counter() - t0:.2f} s: "
                  f"{st.captures} graphs before and after (no recapture); "
                  f"members 0, 1 and 3 bit for bit; member 2 against the "
                  f"incoming model's own rows max |dp| {new_dp:.3e} "
                  f"(tolerance {TOL_STACKED_DENSENET}); the group equals one "
                  f"stacked afresh bit for bit; a request of 17 images "
                  f"served = their stacked mean, max |diff| {err:.3e}",
                  flush=True)
            out.update(windows={k: {q: v for q, v in w.items()
                                    if q != "answers"}
                                for k, w in wins.items()},
                       member_dp=[float(v) for v in dp], times=times)

            # (b) int8: DenseNet-121 on the generic fallback.
            t0 = time.perf_counter()
            val = {}
            for quant in (None, "int8"):
                ms = []
                for p in dn_params:
                    m = TorchDenseNet(device="cuda", **ENSEMBLE_KNOBS)
                    m.load_parameters(p)
                    m.enable_serving_quant(quant)
                    ms.append(m)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                g = stack_members(ms)
                rows = in_bursts(np, lambda x: stacked_rows(np, g, x), imgs,
                                 512)
                torch.cuda.synchronize()
                tensors = (g._vars.values() if quant is None else
                           [t for d in g._vars.values() for t in d.values()])
                val[quant] = {
                    "rows": rows,
                    "peak_gb": (torch.cuda.max_memory_allocated() - base)
                    / 1e9,
                    "weights_mb": sum(t.numel() * t.element_size()
                                      for t in tensors) / 1e6,
                    "report": ms[0].quant_report()}
                g.destroy()
                for m in ms:
                    m.destroy()
                torch.cuda.empty_cache()
            r32, r8 = val[None]["rows"], val["int8"]["rows"]
            agree = (r32.argmax(-1) == r8.argmax(-1)).mean(axis=1)
            acc32 = (r32.argmax(-1) == labels).mean(axis=1)
            acc8 = (r8.argmax(-1) == labels).mean(axis=1)
            rep = val["int8"]["report"]
            check(abs(acc8[0] - acc32[0]) <= TOL_INT8_ACC,
                  f"int8 DenseNet-121 val accuracy {acc8[0]:.4f} against "
                  f"{acc32[0]:.4f} in f32")
            print(f"ensemble: (b) DenseNet-121 int8 on the generic fallback "
                  f"({rep['n_int8']} int8 kernels, {rep['n_f32']} f32 "
                  f"leaves), {ENSEMBLE_MEMBERS} members stacked over "
                  f"{imgs.shape[0]} val images in bursts of 512: argmax "
                  f"agreement with f32 {[float(a) for a in agree]}; val "
                  f"accuracy of the trained member {acc8[0]:.4f} against "
                  f"{acc32[0]:.4f} in f32 (tolerance {TOL_INT8_ACC}); max "
                  f"|dp| {float(np.abs(r8 - r32).max()):.4f}; stacked "
                  f"weights {val[None]['weights_mb']:.1f} MB f32, "
                  f"{val['int8']['weights_mb']:.1f} MB int8; peak device "
                  f"memory over the pass (graphs captured in it) "
                  f"{val[None]['peak_gb']:.3f} GB f32, "
                  f"{val['int8']['peak_gb']:.3f} GB int8 above the "
                  f"{base / 1e9:.3f} GB already held; took "
                  f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)

            # (b) int8: the automl phase's FeedForward trials, stacked.
            t0 = time.perf_counter()
            ff_bin = dep.bin("rafiki_torch.models.feedforward:"
                             "TorchFeedForward", automl["ff_trials"])
            worker, host, info = dep.serve(ff_bin, {wire.QUANT_ENV: "int8"})
            check(info["quant"] == "int8" and info["stacked"] is True,
                  f"the int8 FeedForward bin registered {info}")
            g8 = worker.model.stacked
            g = torch.Generator().manual_seed(SEED)
            n_mm = 0
            for b in (2 ** i for i in range(10)):
                for k, wq in sorted(g8._vars["q"].items()):
                    xq = torch.randint(-127, 128, (b, wq.shape[1]),
                                       dtype=torch.int8, generator=g)
                    got = int8_mm(xq.to("cuda"), wq[0]).cpu()
                    check(torch.equal(got.long(), xq.long()
                                      @ wq[0].cpu().long()),
                          f"int8_mm at bucket {b}, {k}, differs from the "
                          f"int32 product")
                    n_mm += 1
            ff_imgs, ff_labels = automl["ff_val"]
            r8 = in_bursts(np, lambda x: stacked_rows(np, g8, x), ff_imgs,
                           512)
            ms = []
            for knobs, p in automl["ff_trials"]:
                m = TorchFeedForward(device="cuda", **knobs)
                m.load_parameters(p)
                ms.append(m)
            g32 = stack_members(ms)
            r32 = in_bursts(np, lambda x: stacked_rows(np, g32, x), ff_imgs,
                            512)
            g32.destroy()
            acc32 = (r32.argmax(-1) == ff_labels).mean(axis=1)
            acc8 = (r8.argmax(-1) == ff_labels).mean(axis=1)
            ens32 = float((r32.mean(0).argmax(-1) == ff_labels).mean())
            ens8 = float((r8.mean(0).argmax(-1) == ff_labels).mean())
            served = client.predict(host, queries=list(ff_imgs[:3]))[
                "predictions"]
            err = float(np.abs(np.asarray(served) - stacked_rows(
                np, g8, ff_imgs[:3]).astype(np.float64).mean(0)).max())
            check(err <= TOL_ENSEMBLE, f"served int8: {err:.3e}")
            check(float(np.abs(acc8 - acc32).max()) <= TOL_INT8_ACC
                  and abs(ens8 - ens32) <= TOL_INT8_ACC,
                  f"int8 val accuracy {acc8} against {acc32}")
            print(f"ensemble: (b) FeedForward int8: the automl phase's "
                  f"{len(ms)} trials in one bin, registered quant="
                  f"{info['quant']}, stacked={info['stacked']}; int8_mm "
                  f"equal to the int32 product at every bucket 1-512 and "
                  f"layer ({n_mm} products); over {ff_imgs.shape[0]} val "
                  f"images max |dp| against f32 "
                  f"{float(np.abs(r8 - r32).max()):.4e}, val accuracy "
                  f"{[round(float(a), 4) for a in acc8]} against "
                  f"{[round(float(a), 4) for a in acc32]} in f32, the "
                  f"ensemble's {ens8:.4f} against {ens32:.4f} (tolerance "
                  f"{TOL_INT8_ACC}); a request served = the stacked mean, "
                  f"max |diff| {err:.3e}; took {time.perf_counter() - t0:.1f}"
                  f" s on {card}", flush=True)
            for m in ms:
                m.destroy()
        finally:
            dep.close()

    # (d) The phase ran none of the attention kernels.
    launches = launch_counts(attn)
    check(launches[:3] == (0, 0, 0),
          f"the ensemble phase launched K1/K2/K3 {launches[:3]}")
    phase_s = time.perf_counter() - t_phase
    print(f"ensemble: (d) K1, K2 and K3 launched 0 times in the phase; "
          f"phase took {phase_s:.1f} s", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def recording(fn, calls):
    """``fn`` that also keeps each call's arguments in ``calls``."""
    def attend(q, k, v, kv_mask=None):
        calls.append((q, k, v, kv_mask))
        return fn(q, k, v, kv_mask)
    return attend


def plain_attention(attn):
    """The zoo's attention on the plain versions of K1, K2 and K3."""
    return lambda q, k, v, m=None: attn.flash_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), kv_mask=m)


def zoo2_kernels(torch, attn, card, what, q, k, v, mask, tag="zoo2:"):
    """K1, K2 and K3 on one of the zoo's real attention inputs (bf16,
    non-causal) against their plain versions, then timed beside
    ``scaled_dot_product_attention`` and its ``autograd.grad``; returns
    the kernel table's numbers for the shape. ``tag`` begins the line
    it prints."""
    import torch.nn.functional as F

    q, k, v = (x.detach().contiguous() for x in (q, k, v))
    b, h, t, d = q.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    ro, rl = attn.flash_attention_reference(q, k, v, kv_mask=mask,
                                            return_lse=True)
    n1 = attn.flash_attention.variant_launches["wgmma"]
    o, lse = attn.flash_attention(q, k, v, kv_mask=mask, return_lse=True)
    check(attn.flash_attention.variant_launches["wgmma"] == n1 + 1,
          f"K1 did not launch on wgmma at the {what} shape")
    atol = TOL_O_ROW * float(v.float().abs().max()) + TOL_O["bfloat16"][0]
    err_o = (o.float() - ro.float()).abs()
    err_l = (lse - rl).abs()
    check(bool((err_o <= atol + TOL_O["bfloat16"][1]
                * ro.float().abs()).all()), f"K1 o at the {what} shape: "
          f"max |diff| {float(err_o.max()):.3e}")
    check(bool((err_l <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all()),
          f"K1 lse at the {what} shape: max |diff| {float(err_l.max()):.3e}")
    delta = (do.float() * ro.float()).sum(-1)
    args = (q, k, v, do, rl, delta)
    dq = attn.flash_attention_dq(*args, kv_mask=mask)
    dk, dv = attn.flash_attention_dkv(*args, kv_mask=mask)
    rq = attn.flash_attention_dq_reference(*args, kv_mask=mask)
    rk, rv = attn.flash_attention_dkv_reference(*args, kv_mask=mask)
    a, r = TOL_GRAD["bfloat16"]
    errs = {}
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        e = (got.float() - want.float()).abs()
        errs[name] = float(e.max())
        check(bool((e <= a * want.float().abs().max()
                    + r * want.float().abs()).all()),
              f"{name} at the {what} shape: max |diff| {errs[name]:.3e}")
    bias = None if mask is None else mask[:, None, None, :]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    # The library's forward on a side stream, so that its backward (on
    # the forward's stream) can be captured there and timed as the
    # kernels are.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
    torch.cuda.current_stream().wait_stream(side)
    fns = {"K1": (graph_ms, lambda: attn.flash_attention(
               q, k, v, kv_mask=mask)),
           "K2": (graph_ms, lambda: attn.flash_attention_dq(
               *args, kv_mask=mask)),
           "K3": (graph_ms, lambda: attn.flash_attention_dkv(
               *args, kv_mask=mask)),
           "lib1": (graph_ms, lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=bias)),
           "lib23": (functools.partial(graph_ms, stream=side),
                     lambda: torch.autograd.grad(
                         out, (qg, kg, vg), do, retain_graph=True))}
    runs = {key: [] for key in fns}
    # In turns: the kernels, the library, the library, the kernels.
    for group in (("K1", "K2", "K3"), ("lib1", "lib23"),
                  ("lib1", "lib23"), ("K1", "K2", "K3")):
        for key in group:
            timer, fn = fns[key]
            runs[key].append(timer(torch, fn, 20))
    ms1, ms2, ms3, lib1, lib23 = (sum(runs[key]) / 2 for key in
                                  ("K1", "K2", "K3", "lib1", "lib23"))
    p1 = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, kv_mask=mask), 3)
    p2 = time_ms(torch, lambda: attn.flash_attention_dq_reference(
        *args, kv_mask=mask), 3)
    p3 = time_ms(torch, lambda: attn.flash_attention_dkv_reference(
        *args, kv_mask=mask), 3)
    b1, by1 = attention_bound(b, h, t, t, d, False, 2)
    (b2, by2), (b3, by3) = backward_bounds(b, h, t, t, d, False, 2)
    print(f"{tag} kernels at the {what} shape ({b},{h},{t},{t},{d}) bf16 "
          f"non-causal, mask={mask is not None} (the model's own q, k, v): "
          f"K1 max|do| {float(err_o.max()):.3e} (tolerance "
          f"{TOL_O_ROW}*max|v| + TOL_O), max|dlse| {float(err_l.max()):.3e}; "
          f"K2 max|ddq| {errs['dq']:.3e}, K3 max|ddk| {errs['dk']:.3e} "
          f"max|ddv| {errs['dv']:.3e}; CUDA-graph device time K1 "
          f"{ms1:.4f} ms (in turns with the library; plain {p1:.4f}, "
          f"scaled_dot_product_attention "
          f"{lib1:.4f}, bound {b1:.4f} {by1}), K2 {ms2:.4f} ms (plain "
          f"{p2:.4f}, bound {b2:.4f} {by2}), K3 {ms3:.4f} ms (plain "
          f"{p3:.4f}, bound {b3:.4f} {by3}), autograd.grad of "
          f"scaled_dot_product_attention (dq, dk, dv) {lib23:.4f} ms "
          f"(CUDA-graph device time) on {card}", flush=True)
    return {"shape": [b, h, t, t, d], "mask": mask is not None,
            "K1": {"ms": ms1, "plain_ms": p1, "bound_ms": b1,
                   "bound_by": by1, "library_ms": lib1,
                   "max_abs_err": float(err_o.max())},
            "K2": {"ms": ms2, "plain_ms": p2, "bound_ms": b2,
                   "bound_by": by2, "library_ms": lib23,
                   "max_abs_err": errs["dq"]},
            "K3": {"ms": ms3, "plain_ms": p3, "bound_ms": b3,
                   "bound_by": by3, "library_ms": lib23,
                   "max_abs_err": max(errs["dk"], errs["dv"])}}


def zoo2_f32_k1(torch, attn, group, imgs):
    """(c) K1's f32 variant on the int8 ViT path's own q, k and v: one
    eager stacked forward of ``imgs`` (a bucket) with K1's launcher
    keeping each launch's folded inputs and outputs; every block's
    ``o`` and ``lse`` held against ``flash_attention_reference``.
    Returns (shape, max |do|, max |dlse|, the times, the largest share of
    o's tolerance any element takes)."""
    from rafiki_torch.models.vit import MAX_DEPTH

    calls = []
    launch = attn._flash_forward

    def kept(q, k, v, causal, kv_mask, variant=None):
        o, lse = launch(q, k, v, causal, kv_mask, variant)
        calls.append((q, k, v, kv_mask, o, lse))
        return o, lse

    n0 = attn.flash_attention.variant_launches["f32"]
    attn._flash_forward = kept
    try:
        with torch.no_grad():
            group._forward(True)(torch.from_numpy(imgs).to("cuda"))
        torch.cuda.synchronize()
    finally:
        attn._flash_forward = launch
    n_f32 = attn.flash_attention.variant_launches["f32"] - n0
    check(len(calls) == MAX_DEPTH and n_f32 == MAX_DEPTH,
          f"the int8 ViT forward made {len(calls)} K1 launches, {n_f32} "
          f"on f32, not one a block on f32")
    atol, rtol = TOL_O["float32"]
    err_o = err_l = share = 0.0
    for i, (q, k, v, mask, o, lse) in enumerate(calls):
        check(q.dtype == torch.float32
              and attn.flash_forward_variant(q, k, v) == "f32",
              f"block {i}'s K1 inputs are {q.dtype}, not K1's f32 variant")
        ro, rl = attn.flash_attention_reference(q, k, v, kv_mask=mask,
                                                return_lse=True)
        eo, el = (o - ro).abs(), (lse - rl).abs()
        check(bool((eo <= atol + rtol * ro.abs()).all()),
              f"f32 K1 o at block {i}: max |diff| {float(eo.max()):.3e}")
        check(bool((el <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all()),
              f"f32 K1 lse at block {i}: max |diff| {float(el.max()):.3e}")
        err_o, err_l = max(err_o, float(eo.max())), max(err_l,
                                                        float(el.max()))
        share = max(share, float((eo / (atol + rtol * ro.abs())).max()))
    return list(calls[0][0].shape), err_o, err_l, zoo2_f32_times(
        torch, attn, *calls[0][:4]), share


def zoo2_f32_times(torch, attn, q, k, v, mask):
    """K1's f32 variant on one block's q, k, v as a CUDA graph, in turns
    with ``scaled_dot_product_attention`` in f32 (kernel, library,
    library, kernel), beside its plain version and its bound at 4 bytes
    an element and the f32 peak."""
    import torch.nn.functional as F

    b, h, t, d = q.shape
    bias = None if mask is None else mask[:, None, None, :]
    fns = {"K1": lambda: attn.flash_attention(q, k, v, kv_mask=mask),
           "lib": lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=bias)}
    runs = {key: [] for key in fns}
    for key in ("K1", "lib", "lib", "K1"):
        runs[key].append(graph_ms(torch, fns[key], 20))
    plain = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, kv_mask=mask), 3)
    bound_ms, bound_by = attention_bound(b, h, t, t, d, False, 4)
    return {"ms": sum(runs["K1"]) / 2, "library_ms": sum(runs["lib"]) / 2,
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [b, h, t, t, d]}


def int8_replay_ms(torch, group, bucket):
    """Device ms of one replay of ``group``'s int8 runner at ``bucket``
    (CUDA events over 10 replays)."""
    runner = next((r for key, r in group._runners.runners.items()
                   if key[0] == bucket and key[2] == "int8"), None)
    check(runner is not None and runner.graph is not None,
          f"no captured int8 runner at bucket {bucket}")
    return time_ms(torch, runner.graph.replay, 10)


def logged(fn, *args, **kw):
    """``fn(*args, **kw)`` with the model logger's records kept; returns
    (result, the epoch records' values)."""
    from rafiki_torch.model.logger import logger

    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        out = fn(*args, **kw)
    finally:
        logger.set_sink(prior)
    return out, [r["values"] for r in recs
                 if r["type"] == "values" and "epoch" in r["values"]]


def zoo2_vit(torch, np, attn, card, train, val):
    """(a) ViT at full width trains one epoch; its step on the kernels
    against the plain attention; K1-K3 at its shape."""
    import torch.nn.functional as F

    from rafiki_torch.model import torch_model
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import TorchViT
    from rafiki_torch.models.vit import MAX_DEPTH

    ds = load_image_dataset(train)
    vds = load_image_dataset(val)
    b = ZOO2_VIT["batch_size"]
    x0 = torch.from_numpy(ds.images[:b]).to("cuda").float() / 255.0
    y0 = torch.from_numpy(ds.labels[:b]).to("cuda")

    def batch_loss(m, net):
        with torch.no_grad():
            return float(F.cross_entropy(m._logits(net, x0).float(), y0))

    m = TorchViT(device="cuda", **ZOO2_VIT)
    loss0 = batch_loss(m, m._new_net(ds.n_classes, ds.image_shape))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(attn)
    t0 = time.perf_counter()
    _, epochs = logged(m.train, train)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = [a - c for a, c in zip(launch_counts(attn), before)]
    steps = ds.size // b
    check(len(epochs) == 1 and math.isfinite(epochs[0]["loss"]),
          f"ViT epochs logged: {epochs}")
    ep = epochs[0]
    loss1 = batch_loss(m, m._net)
    acc = m.evaluate(val)
    check(loss1 < loss0 and ep["loss"] < loss0, f"the ViT loss did not "
          f"fall: {loss0:.4f} before, epoch mean {ep['loss']:.4f}, "
          f"{loss1:.4f} after")
    check(acc >= ZOO2_VIT_MIN_ACC, f"ViT val accuracy {acc:.4f}")
    # Counted on the host: the eager warm-up steps and the capture, once
    # each; the replays run the captured launches without the wrapper.
    # The chip_util count (``_macs``) runs one forward of one image.
    runs = torch_model.WARMUP_STEPS + 1
    L = MAX_DEPTH
    per_step = ((got[0] - L) / runs, got[1] / runs, got[2] / runs)
    check(per_step == (L, L, L) and got[3:] == got[:3],
          f"ViT launches {got}: per step {per_step}, not {L} each on wgmma")
    sps = ep["steps_per_sec"]
    n_params = sum(p.numel() for p in m._net.parameters())
    macs = m._macs(m._net, ds.image_shape)
    print(f"zoo2: (a) ViT (d_model 128, 4 heads of 32, patch 4, 65 tokens, "
          f"6 blocks, {n_params} parameters), batch {b}, lr 1e-3, wd 1e-4 "
          f"coupled: one epoch of {steps} steps in {train_s:.2f} s (capture "
          f"included), {sps:.2f} steps/s over the epoch, {sps * b:.1f} "
          f"images/s, chip_util {ep.get('chip_util')} ({2 * macs / 1e9:.4f} "
          f"GFLOP an image forward, attention included), peak device memory "
          f"{peak_gb:.2f} GB; loss on {b} train images {loss0:.4f} before, "
          f"epoch mean {ep['loss']:.4f}, {loss1:.4f} after; val accuracy "
          f"{acc:.4f} ({vds.size} images) on {card}", flush=True)
    print(f"zoo2: (a) launches counted by the wrappers over the train: K1 "
          f"{got[0]}, K2 {got[1]}, K3 {got[2]}, all wgmma: {L} K1 (one a "
          f"block), {L} K2 and {L} K3 a step, counted at the "
          f"{torch_model.WARMUP_STEPS} eager steps and the capture (the "
          f"{steps - runs} replays run them uncounted: {L * steps} launches "
          f"of each on the card), plus {L} K1 of the one-image chip_util "
          f"count", flush=True)

    # One captured step, timed and profiled.
    net = m._new_net(ds.n_classes, ds.image_shape)
    opt = m.create_optimizer(list(net.parameters()), steps, 1)
    data = torch.from_numpy(ds.images).to("cuda")
    labels = torch.from_numpy(ds.labels).to("cuda")
    runner = torch_model._TrainSteps(m, net, opt, data, labels, steps, b)
    runner.new_epoch(np.arange(steps * b).reshape(steps, b))
    net.train()
    for _ in range(torch_model.WARMUP_STEPS + 2):
        runner.step()
    check(runner.graph is not None, "the ViT step was not captured")
    step_ms = time_ms(torch, runner.step, 20)
    prof = profile(torch, runner.step, f"one captured ViT train step "
                   f"(batch {b})", card, top=10)
    runner.close()
    del runner, data, labels, opt

    # One step on the kernels against the same step on the plain
    # versions, and K1-K3 at the ViT shape on the model's own q, k, v.
    calls = []
    net.attention = recording(net.attention, calls)
    grads = {}
    for name in ("kernels", "plain"):
        net.zero_grad(set_to_none=True)
        loss = F.cross_entropy(m._logits(net, x0).float(), y0)
        loss.backward()
        grads[name] = (float(loss.detach()), {n: p.grad.detach().clone()
                                     for n, p in net.named_parameters()})
        net.attention = plain_attention(attn)
    (lk, gk), (lp, gp) = grads["kernels"], grads["plain"]
    errs = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in gp
            if float(gp[n].norm()) > 0}
    worst = max(errs, key=errs.get)
    print(f"zoo2: (a) one step on the kernels vs flash_attention_plain, same "
          f"weights and batch: loss {lk:.6f} vs {lp:.6f} (|diff| "
          f"{abs(lk - lp):.3e}, tolerance {TOL_STEP_LOSS}); gradient "
          f"relative error max {errs[worst]:.3e} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)} "
          f"parameters (tolerance {TOL_STEP_GRAD})", flush=True)
    check(abs(lk - lp) <= TOL_STEP_LOSS and errs[worst] <= TOL_STEP_GRAD,
          "the ViT step on the kernels disagrees with the plain step")
    q, k, v, mask = calls[0]
    with uncounted(attn):
        kern = zoo2_kernels(torch, attn, card, "ViT", q, k, v, mask)
    del net, grads, gk, gp, calls
    torch.cuda.empty_cache()
    return m, {"train_s": train_s, "steps_per_sec": sps,
               "images_per_sec": sps * b, "chip_util": ep.get("chip_util"),
               "peak_gb": peak_gb, "val_acc": acc, "step_ms": step_ms,
               "busy_share": (prof[1] / 1e3 / step_ms) if prof else None,
               "loss": [loss0, ep["loss"], loss1], "launches": got[:3],
               "kernels": kern}


def int8_conv_exact(torch, wq, in_hw, strides, padding, buckets, what):
    """``int8_conv`` on the card against the exact convolution (float64,
    exact for these sums) of random int8 inputs, at each bucket."""
    from rafiki_torch.model.torch_model import conv_padding, int8_conv

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kh, kw, cin, _ = wq.shape
    (pt, pb), (pl, pr) = conv_padding(padding, in_hw, (kh, kw), strides)
    for b in buckets:
        xq = torch.randint(-127, 128, (b, *in_hw, cin), dtype=torch.int8,
                           device="cuda", generator=g)
        got = int8_conv(xq, wq, strides, padding)
        want = conv64(torch, xq, wq, strides, (pt, pb, pl, pr))
        check(torch.equal(got.long(), want),
              f"int8_conv {what} at bucket {b} differs from the exact "
              "convolution")
    return len(buckets)


def conv64(torch, xq, wq, strides, pads):
    """The exact int32 result of an int8 NHWC × HWIO convolution, from a
    float64 convolution (sums below 2^53) on the card."""
    import torch.nn.functional as F

    pt, pb, pl, pr = pads
    x = F.pad(xq.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(x, wq.double().permute(3, 2, 0, 1), stride=strides)
    return y.permute(0, 2, 3, 1).round().long()


def zoo2_phase(torch, np, attn, card, image_set=None):
    """The rest of the zoo on the card: (a) ViT at full width, (b) a
    Bayes search of ViT trials and the 2 best stacked behind the
    predictor, (c) int8 serving of ViT and the CNN, (d) the CNN at full
    width, (e) the transformer tagger at full width, (f) the tabular
    MLPs and the BiLSTM through ``test_model_class``. ``image_set`` is
    the zoo phase's (train, val) paths; None makes the set anew.
    Returns the phase's numbers and K1-K3 launches."""
    import os
    import tempfile

    from rafiki_torch.advisor import BayesOptAdvisor, make_advisor
    from rafiki_torch.client import Client
    from rafiki_torch.constants import TaskType, TrialStatus
    from rafiki_torch.datasets import (make_synthetic_image_dataset,
                                       make_synthetic_tabular_dataset)
    from rafiki_torch.model import test_model_class
    from rafiki_torch.model.dataset import (load_corpus_dataset,
                                            load_image_dataset)
    from rafiki_torch.models import (TorchCnn, TorchPosTagger,
                                     TorchTabMlpClf, TorchTabMlpReg)
    from rafiki_torch.models.vit import MAX_DEPTH
    from rafiki_torch.observe import wire
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class
    from rafiki_torch.worker import InferenceWorker

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    out = {}
    client = Client()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train, val = image_set or make_synthetic_image_dataset(
            tmp, seed=SEED, **ZOO_DATA)
        vds = load_image_dataset(val)
        imgs, labels = vds.images[:ZOO2_VAL], vds.labels[:ZOO2_VAL]
        if image_set is None:
            print(f"zoo2: the zoo phase's synthetic "
                  f"{ZOO_DATA['name']}-shaped set made anew in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)

        # (a) ViT at full width.
        t0 = time.perf_counter()
        vit, out["vit"] = zoo2_vit(torch, np, attn, card, train, val)
        print(f"zoo2: (a) took {time.perf_counter() - t0:.1f} s", flush=True)

        # (b) A Bayes search of ViT trials; the 2 best stacked.
        t0 = time.perf_counter()
        meta = MetaStore(os.path.join(tmp, "meta.db"))
        params = ParamStore(os.path.join(tmp, "params"))
        user = meta.create_user("zoo2@example.com", "-", "MODEL_DEVELOPER")
        vit_cls = load_model_class("ZooViT", ZOO2_VIT_SOURCE)
        row = meta.create_model(user["id"], "vit",
                                TaskType.IMAGE_CLASSIFICATION, "ZooViT", {},
                                model_source=ZOO2_VIT_SOURCE)
        advisor = make_advisor(vit_cls.get_knob_config(), seed=SEED,
                               total_trials=ZOO2_VIT_TRIALS, device="cuda")
        check(isinstance(advisor, BayesOptAdvisor),
              f"make_advisor chose {type(advisor).__name__} for ViT")
        job, rows, search_s = zoo_search(meta, params, row, vit_cls, train,
                                         val, ZOO2_VIT_TRIALS, advisor,
                                         "zoo2-vit")
        check(len(rows) == ZOO2_VIT_TRIALS and all(
            r["status"] == TrialStatus.COMPLETED for r in rows),
            f"ViT trials: {[(r['status'], r.get('error')) for r in rows]}")
        for r in rows:
            ep = epoch_values(meta, r["id"])
            print(f"zoo2: (b) trial {r['no']}: knobs "
                  f"{json.dumps(r['knobs'])}: "
                  f"{r['finished_at'] - r['started_at']:.2f} s, "
                  f"{ep[-1]['steps_per_sec']:.2f} steps/s, chip_util "
                  f"{ep[-1].get('chip_util')}, epoch loss "
                  f"{ep[-1]['loss']:.4f}, val accuracy {r['score']:.4f}",
                  flush=True)
        print(f"zoo2: (b) Bayes search (make_advisor chose "
              f"{type(advisor).__name__}) of {ZOO2_VIT_TRIALS} one-epoch ViT "
              f"trials in {search_s:.2f} s: "
              f"{ZOO2_VIT_TRIALS * 3600 / search_s:.1f} trials/hour on "
              f"{card}", flush=True)
        top = meta.get_best_trials_of_train_job(job["id"],
                                                max_count=ZOO2_DEPLOY)
        # Served, not trained: max_epochs takes the knob space's least.
        members = [(dict(t["knobs"], max_epochs=3), params.load(
            t["params_id"])) for t in top]
        # The lifecycle phase serves all of the search's trials, best
        # first, on the same val images.
        out["lifecycle"] = {
            "trials": [(dict(t["knobs"], max_epochs=3),
                        params.load(t["params_id"]), float(t["score"]))
                       for t in meta.get_best_trials_of_train_job(
                           job["id"], max_count=ZOO2_VIT_TRIALS)],
            "val": (imgs, labels)}
        # The operator phase uploads the set's first train images.
        tds = load_image_dataset(train)
        out["operator"] = {"train": (tds.images[:OPERATOR_TRAIN],
                                     tds.labels[:OPERATOR_TRAIN]),
                           "n_classes": tds.n_classes}
        del tds
        params.close()
        meta.close()
        dep = EnsembleDeploy(os.path.join(tmp, "deploy"))
        try:
            vit_bin = dep.bin("rafiki_torch.models.vit:TorchViT", members)
            worker, host, info = dep.serve(vit_bin, {})
            ens = worker.model
            check(info["stacked"] is True, f"the ViT bin registered {info}")
            st = ens.stacked
            # Each bucket a window of single images reaches, built now:
            # the wrappers count K1 at the eager run and at the capture.
            n0 = attn.flash_attention.launches
            for bk in (2, 4, 8):
                ens.predict_staged_submit(
                    np.zeros((bk, *imgs.shape[1:]), np.uint8), bk)()
            per_build = (attn.flash_attention.launches - n0) / 3
            check(per_build == 2 * MAX_DEPTH,
                  f"a stacked ViT runner's build launched K1 {per_build} "
                  f"times, not once a block at its run and its capture")
            reset_counts(ens)
            worst = 0.0
            for i, n in enumerate((1, 2, 3, 5, 8)):
                x = imgs[8 * i:8 * i + n]
                served = client.predict(host, queries=list(x))[
                    "predictions"]
                rows_ = stacked_rows(np, st, x)
                worst = max(worst, float(np.abs(
                    np.asarray(served) - rows_.astype(np.float64).mean(0))
                    .max()))
            check(worst <= TOL_ENSEMBLE, f"served ViT answers differ from "
                  f"the members' mean by {worst:.3e}")
            win = platform_window(np, client, host, imgs[:AUTOML_WINDOW],
                                  card, tag="zoo2: (b)",
                                  what=f"one worker serving a {ZOO2_DEPLOY}"
                                  f"-member ViT bin (stacked)")
            bursts = sum(ens.bursts.values())
            check(ens.bursts["stacked"] == bursts > 0 and
                  ens.dispatches["stacked"] == bursts,
                  f"ViT window bursts {ens.bursts}, dispatches "
                  f"{ens.dispatches}")
            models = ens.models
            rows_st = in_bursts(np, lambda x: stacked_rows(np, st, x),
                                imgs[:64], 8)
            rows_pm = np.stack([in_bursts(
                np, lambda x, m=m: member_rows(np, m, x), imgs[:64], 8)
                for m in models])
            dp = float(np.abs(rows_st - rows_pm).max())
            check(dp <= TOL_STACKED_FF, f"stacked ViT rows differ from "
                  f"each member's own by {dp:.3e}")
            print(f"zoo2: (b) the {ZOO2_DEPLOY} best trials "
                  f"({[t['no'] for t in top]}) stacked in one bin "
                  f"(registered stacked={info['stacked']}): a stacked "
                  f"runner's build launched K1 {per_build:.0f} times "
                  f"({MAX_DEPTH} at its run, {MAX_DEPTH} at its "
                  f"capture: once a block for both members, folded into "
                  f"the batch); 5 requests served = float64 mean of the "
                  f"members' stacked rows, max |diff| {worst:.3e} "
                  f"(tolerance {TOL_ENSEMBLE}); the window ran {bursts} "
                  f"bursts, all stacked, one dispatch each; stacked rows "
                  f"against each member's own over 64 images max |dp| "
                  f"{dp:.3e} (tolerance {TOL_STACKED_FF})", flush=True)
            out["vit_serve"] = dict({q: w for q, w in win.items()
                                     if q != "answers"}, served_err=worst,
                                    member_dp=dp, search_s=search_s)
            print(f"zoo2: (b) took {time.perf_counter() - t0:.1f} s",
                  flush=True)

            # (d) The CNN at full width.
            t0 = time.perf_counter()
            ds = load_image_dataset(train)
            cnn = TorchCnn(device="cuda", **ZOO2_CNN)
            before = launch_counts(attn)
            t1 = time.perf_counter()
            _, epochs = logged(cnn.train, train)
            torch.cuda.synchronize()
            cnn_s = time.perf_counter() - t1
            cnn_acc = cnn.evaluate(val)
            check(launch_counts(attn)[:3] == before[:3],
                  "the CNN launched K1/K2/K3")
            ep = epochs[0]
            dumped = cnn.dump_parameters()
            on_cpu = TorchCnn(device="cpu", **ZOO2_CNN)
            on_cpu.load_parameters(dumped)
            probes = imgs[:ZOO_PROBES]
            with torch.no_grad():
                lc = cnn._logits(cnn._net, torch.from_numpy(probes).to(
                    "cuda").float() / 255.0).float().cpu().numpy()
                lh = on_cpu._logits(on_cpu._net, torch.from_numpy(
                    probes).float() / 255.0).float().numpy()
            diff = float(np.abs(lc - lh).max())
            check(diff <= TOL_ZOO_LOGITS, f"CNN card vs CPU logits {diff}")
            check(math.isfinite(ep["loss"]) and cnn_acc >= ZOO2_CNN_MIN_ACC,
                  f"CNN epoch {ep}, val accuracy {cnn_acc}")
            sps = ep["steps_per_sec"]
            print(f"zoo2: (d) CNN (64/128/256 channels at 16/16, "
                  f"{sum(p.numel() for p in cnn._net.parameters())} "
                  f"parameters), batch 256: one epoch of "
                  f"{ds.size // 256} steps in {cnn_s:.2f} s (capture "
                  f"included), {sps:.2f} steps/s, {sps * 256:.1f} images/s, "
                  f"chip_util {ep.get('chip_util')}, epoch loss "
                  f"{ep['loss']:.4f}, val accuracy {cnn_acc:.4f} (floor "
                  f"{ZOO2_CNN_MIN_ACC}); card vs "
                  f"CPU logits on the same parameters max |diff| "
                  f"{diff:.4e} (tolerance {TOL_ZOO_LOGITS}); no K1-K3 "
                  f"launch; took {time.perf_counter() - t0:.1f} s on {card}",
                  flush=True)
            out["cnn"] = {"train_s": cnn_s, "steps_per_sec": sps,
                          "images_per_sec": sps * 256,
                          "chip_util": ep.get("chip_util"),
                          "val_acc": cnn_acc, "logit_diff": diff}
            on_cpu.destroy()

            # (c) int8: the 2 ViT members stacked, and the CNN.
            t0 = time.perf_counter()
            worker8, host8, info8 = dep.serve(vit_bin,
                                              {wire.QUANT_ENV: "int8"})
            check(info8["quant"] == "int8" and info8["stacked"] is True,
                  f"the int8 ViT bin registered {info8}")
            g8 = worker8.model.stacked
            f32_0 = attn.flash_attention.variant_launches["f32"]
            r8 = in_bursts(np, lambda x: stacked_rows(np, g8, x), imgs, 512)
            f32_k1 = attn.flash_attention.variant_launches["f32"] - f32_0
            check(f32_k1 > 0, "the int8 ViT path launched no f32 K1")
            with uncounted(attn):
                f32_shape, f32_do, f32_dlse, f32_t, f32_share = zoo2_f32_k1(
                    torch, attn, g8, imgs[:512])
                replay_ms = int8_replay_ms(torch, g8, 512)
            r32 = in_bursts(np, lambda x: stacked_rows(np, st, x), imgs, 512)
            acc32 = (r32.argmax(-1) == labels).mean(axis=1)
            acc8 = (r8.argmax(-1) == labels).mean(axis=1)
            served = client.predict(host8, queries=list(imgs[:3]))[
                "predictions"]
            err8 = float(np.abs(np.asarray(served) - stacked_rows(
                np, g8, imgs[:3]).astype(np.float64).mean(0)).max())
            check(err8 <= TOL_ENSEMBLE, f"served int8 ViT: {err8:.3e}")
            check(float(np.abs(acc8 - acc32).max()) <= TOL_INT8_ACC,
                  f"int8 ViT val accuracy {acc8} against {acc32}")
            buckets = [2 ** i for i in range(10)]
            n_conv = int8_conv_exact(
                torch, g8._vars["q"]["params/Conv_0/kernel"][0], (32, 32),
                (4, 4), "VALID", buckets, "ViT patches")
            cnn.enable_serving_quant("int8")
            q8 = cnn._quant_device_arrays()[0]
            hw = 32
            for i in range(6):
                n_conv += int8_conv_exact(
                    torch, q8[f"params/Conv_{i}/kernel"], (hw, hw), (1, 1),
                    ((1, 1), (1, 1)), buckets, f"CNN Conv_{i}")
                if i % 2 == 1:
                    hw //= 2
            c8 = cnn.predict_proba(vds.images)
            cnn.enable_serving_quant(None)
            c32 = cnn.predict_proba(vds.images)
            cacc8 = float((c8.argmax(-1) == vds.labels).mean())
            cacc32 = float((c32.argmax(-1) == vds.labels).mean())
            check(abs(cacc8 - cacc32) <= TOL_INT8_ACC,
                  f"int8 CNN val accuracy {cacc8} against {cacc32}")
            print(f"zoo2: (c) int8: the ViT bin under "
                  f"RAFIKI_TPU_SERVING_QUANT=int8 (registered quant="
                  f"{info8['quant']}, stacked={info8['stacked']}) over "
                  f"{imgs.shape[0]} val images: max |dp| against f32 "
                  f"{float(np.abs(r8 - r32).max()):.4e}, val accuracy "
                  f"{[round(float(a), 4) for a in acc8]} against "
                  f"{[round(float(a), 4) for a in acc32]} in f32 (tolerance "
                  f"{TOL_INT8_ACC}); K1 launched {f32_k1} times on its f32 "
                  f"variant; its f32 launches of one eager stacked forward "
                  f"({f32_shape[0]},{f32_shape[1]},{f32_shape[2]},"
                  f"{f32_shape[2]},{f32_shape[3]}) against "
                  f"flash_attention_reference, all {MAX_DEPTH} blocks: max "
                  f"|do| {f32_do:.3e} (tolerance {TOL_O['float32']}; the "
                  f"largest element takes {f32_share:.3f} of its own), max "
                  f"|dlse| {f32_dlse:.3e} (tolerance {TOL_LSE}); as a CUDA "
                  f"graph {f32_t['ms']:.4f} ms (in turns with "
                  f"scaled_dot_product_attention in f32 "
                  f"{f32_t['library_ms']:.4f} ms; plain "
                  f"{f32_t['plain_ms']:.4f} ms; bound "
                  f"{f32_t['bound_ms']:.4f} ms {f32_t['bound_by']} at 4 "
                  f"bytes an element and {PEAK_F32_FLOPS:.3g} FLOP/s); a "
                  f"request "
                  f"served = the stacked mean, max "
                  f"|diff| {err8:.3e}. The CNN int8 over {vds.size} val "
                  f"images: max |dp| {float(np.abs(c8 - c32).max()):.4e}, "
                  f"val accuracy {cacc8:.4f} against {cacc32:.4f}. "
                  f"int8_conv equal to the exact convolution at buckets "
                  f"1-512 for the ViT patches and the CNN's 6 convolutions "
                  f"({n_conv} convolutions); took "
                  f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
            k1_share = MAX_DEPTH * f32_t["ms"] / replay_ms
            print(f"zoo2: (c) one replay of the int8 stacked ViT runner at "
                  f"bucket 512 (2 members): {replay_ms:.4f} ms (CUDA "
                  f"events, 10 replays); its {MAX_DEPTH} f32 K1 launches "
                  f"at {f32_t['ms']:.4f} ms each (the graph time above) "
                  f"take {100 * k1_share:.1f}% of it, on {card}", flush=True)
            out["int8"] = {"vit_acc": [float(a) for a in acc8],
                           "vit_acc_f32": [float(a) for a in acc32],
                           "vit_dp": float(np.abs(r8 - r32).max()),
                           "cnn_acc": cacc8, "cnn_acc_f32": cacc32,
                           "cnn_dp": float(np.abs(c8 - c32).max()),
                           "k1_f32_launches": f32_k1,
                           "k1_f32_shape": f32_shape, "k1_f32_do": f32_do,
                           "k1_f32_dlse": f32_dlse,
                           "k1_f32": dict(f32_t, launches=f32_k1,
                                          launches_a_forward=MAX_DEPTH,
                                          max_abs_err=f32_do,
                                          tolerance_share=f32_share,
                                          replay_ms=replay_ms,
                                          share_of_replay=k1_share)}
            cnn.destroy()
        finally:
            dep.close()
        vit.destroy()

        # (e) The transformer tagger at full width.
        t0 = time.perf_counter()
        out["tagger"], corpus = zoo2_tagger(torch, np, attn, card, tmp)
        print(f"zoo2: (e) took {time.perf_counter() - t0:.1f} s", flush=True)

        # (f) The tabular MLPs and the BiLSTM through test_model_class.
        t0 = time.perf_counter()
        before = launch_counts(attn)
        tab_cls, tab_reg = (make_synthetic_tabular_dataset(
            os.path.join(tmp, name), n_classes=n, seed=SEED, name=name,
            **ZOO2_TABLE) for name, n in (("adult", 2), ("adult_reg", 0)))
        rng = np.random.default_rng(SEED)
        rows_q = rng.standard_normal((5, ZOO2_TABLE["n_features"])).tolist()
        sents = load_corpus_dataset(corpus[1]).sentences[:5]
        out["tab_pos"] = {}
        for cls, task, data, knobs, queries in (
                (TorchTabMlpClf, TaskType.TABULAR_CLASSIFICATION, tab_cls,
                 ZOO2_TAB_KNOBS, rows_q),
                (TorchTabMlpReg, TaskType.TABULAR_REGRESSION, tab_reg,
                 ZOO2_TAB_KNOBS, rows_q),
                (TorchPosTagger, TaskType.POS_TAGGING, corpus,
                 ZOO2_POS_KNOBS, sents)):
            out["tab_pos"][cls.__name__] = zoo2_model_class(
                np, card, cls, task, data, knobs, queries, test_model_class,
                InferenceWorker, PredictorService)
        check(launch_counts(attn)[:3] == before[:3],
              "the tabular MLPs or the BiLSTM launched K1/K2/K3")
        print(f"zoo2: (f) took {time.perf_counter() - t0:.1f} s; no K1-K3 "
              f"launch", flush=True)

    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(all(n > 0 for n in launches[:3]),
          f"the zoo2 phase launched K1/K2/K3 {launches[:3]}")
    print(f"zoo2: K1, K2 and K3 launched {launches[:3]} times in the phase "
          f"(counted by the wrappers; captured steps count once); phase "
          f"took {phase_s:.1f} s", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def zoo2_model_class(np, card, cls, task, data, knobs, queries,
                     test_model_class, InferenceWorker, PredictorService):
    """One trial of ``cls`` through ``test_model_class`` on the card, its
    parameters served by an ``InferenceWorker`` behind ``POST
    /predict``: the served answers must be the worker's own."""

    class Keep(cls):
        dumped = None

        def dump_parameters(self):
            out = super().dump_parameters()
            type(self).dumped = out
            return out

    t0 = time.perf_counter()
    res = test_model_class(Keep, task, data[0], data[1],
                           test_queries=queries, knobs=knobs, device="cuda")
    secs = time.perf_counter() - t0
    worker = InferenceWorker(cls, knobs, Keep.dumped, device="cuda").start()
    app = PredictorService([worker], device="cuda").start()
    try:
        status, resp, _ = post(app.url + "/predict", {"queries": queries})
        check(status == 200, f"/predict answered {status}")
        own = worker.predict(queries, timeout=60)
    finally:
        app.stop()
        worker.stop()
    err = max(float(np.abs(np.asarray(s, np.float64)
                           - np.asarray(o, np.float64)).max())
              for s, o in zip(resp["predictions"], own))
    check(err <= TOL_ENSEMBLE, f"{cls.__name__} served {err:.3e} off")
    eps = [r["values"] for r in res.log_records
           if r["type"] == "values" and "epoch" in r["values"]]
    print(f"zoo2: (f) {cls.__name__} ({task}) through test_model_class on "
          f"the card: knobs {json.dumps(res.knobs)}, {len(eps)} epochs, last "
          f"epoch loss {eps[-1]['loss']:.4f}, score {res.score:.4f}, "
          f"{secs:.2f} s (train, evaluate, the parameter round trip, "
          f"predict); {len(queries)} queries served through POST /predict "
          f"= the worker's own predict, max |diff| {err:.3e} on {card}",
          flush=True)
    return {"score": res.score, "seconds": secs, "served_err": err}


def zoo2_tagger(torch, np, attn, card, tmp):
    """(e) The transformer tagger at full width on a corpus cut from the
    WSJ POS split's size (``ZOO2_CORPUS``): one epoch, the kernels at its shape on its own q, k, v
    with ``kv_mask``, one block's output and the logits on the kernels
    against the plain attention, served through ``POST /predict``."""
    import os

    import torch.nn.functional as F

    from rafiki_torch.datasets import make_synthetic_corpus_dataset
    from rafiki_torch.model.dataset import load_corpus_dataset
    from rafiki_torch.models import TorchTransformerTagger
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.worker import InferenceWorker

    t0 = time.perf_counter()
    corpus = make_synthetic_corpus_dataset(os.path.join(tmp, "wsj"),
                                           seed=SEED, name="wsj",
                                           **ZOO2_CORPUS)
    ds = load_corpus_dataset(corpus[0])
    n_tok = sum(len(s) for s in ds.sentences)
    print(f"zoo2: (e) synthetic corpus: {ds.size} train sentences "
          f"({n_tok} tokens, lengths 3-{ZOO2_CORPUS['max_len']}), "
          f"{ZOO2_CORPUS['n_val']} val, {ZOO2_CORPUS['vocab']} words, "
          f"{len(ds.tag_names)} tags; made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    m = TorchTransformerTagger(device="cuda", **ZOO2_TAGGER)
    b, t = ZOO2_TAGGER["batch_size"], ZOO2_TAGGER["max_len"]
    steps = ds.size // b
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(attn)
    t0 = time.perf_counter()
    _, epochs = logged(m.train, corpus[0])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = [a - c for a, c in zip(launch_counts(attn), before)]
    L = ZOO2_TAGGER["n_layers"]
    check(got[:3] == [L * steps] * 3 and got[3:] == got[:3],
          f"tagger launches {got}, not {L * steps} each on wgmma")
    ep = epochs[0]
    acc = m.evaluate(corpus[1])
    check(math.isfinite(ep["loss"]) and acc >= ZOO2_TAGGER_MIN_ACC,
          f"tagger epoch {ep}, val token accuracy {acc:.4f}")
    real = n_tok / ds.size * b  # mean real tokens a batch
    print(f"zoo2: (e) tagger (d_model 256, 4 heads of 64, 6 layers, max_len "
          f"128, vocab 16384, dropout 0.1, "
          f"{sum(p.numel() for p in m._net.parameters())} parameters), "
          f"batch 64: one epoch of {steps} eager steps in {train_s:.2f} s, "
          f"{steps / train_s:.2f} steps/s, {steps * b * t / train_s:.1f} "
          f"tokens/s padded ({steps * real / train_s:.1f} real), peak "
          f"device memory {peak_gb:.2f} GB; epoch loss {ep['loss']:.4f}, "
          f"train token accuracy {ep['token_acc']:.4f}, val token accuracy "
          f"{acc:.4f} (chance {1 / len(ds.tag_names):.4f}); K1, K2 and K3 "
          f"launched {got[:3]} times ({L} each a step, all wgmma, with "
          f"kv_mask) on {card}", flush=True)

    # One eager step, profiled.
    net = m._net.train()
    ids, _ = m._encode(ds.sentences[:b])
    ids = torch.from_numpy(ids).to("cuda")
    tags = torch.zeros((b, t), dtype=torch.int64, device="cuda")
    step_t = torch.zeros((), dtype=torch.int64, device="cuda")

    def one_step():
        net.zero_grad(set_to_none=True)
        out = m.logits(net, ids, None, step_t)
        F.cross_entropy(out.transpose(1, 2), tags).backward()

    step_ms = time_ms(torch, one_step, 5)
    prof = profile(torch, one_step, f"one eager tagger forward and backward "
                   f"(batch {b} x {t})", card, top=10)
    net.zero_grad(set_to_none=True)
    net.eval()
    del tags

    # The kernels at the predict shape on the model's own q, k, v: 63
    # val sentences and one all-PAD row, as predict pads a bucket.
    vds = load_corpus_dataset(corpus[1])
    pids, _ = m._encode(vds.sentences[:b - 1])
    pids = torch.from_numpy(np.concatenate(
        [pids, np.zeros((1, t), pids.dtype)])).to("cuda")
    real_rows = slice(0, b - 1)
    calls = []
    with torch.no_grad():
        lk = m.logits(net, pids, None).float()
        x_in = net.Embed_0(pids) + net.pe[None, :t].to(torch.bfloat16)
        blk = net._EncoderBlock_0
        attend = recording(m.attention, calls)
        yk = blk(x_in, attend, pids != 0)
        yp = blk(x_in, plain_attention(attn), pids != 0)
        saved = m.attention
        m.attention = plain_attention(attn)
        lp = m.logits(net, pids, None).float()
        m.attention = saved
    q, k, v, mask = calls[0]
    with uncounted(attn):
        kern = zoo2_kernels(torch, attn, card, "tagger", q, k, v, mask)
    keep = (pids != 0)[real_rows]
    block_err = float((yk - yp).float().abs()[real_rows].max())
    block_tol = TOL_BLOCK * float(yp.float().abs()[real_rows].max())
    logit_err = float((lk - lp).abs()[real_rows][keep].max())
    check(block_err <= block_tol, f"the tagger's block 0 on the kernels: "
          f"{block_err:.3e} from the plain attention")
    check(logit_err <= TOL_ZOO_LOGITS, f"the tagger's logits on the "
          f"kernels: {logit_err:.3e} from the plain attention")
    print(f"zoo2: (e) block 0's output on the kernels against the plain "
          f"attention over the 63 real rows: max |diff| {block_err:.3e} "
          f"(tolerance {block_tol:.3e}: {TOL_BLOCK} of its largest value); "
          f"the logits at real tokens max |diff| {logit_err:.3e} "
          f"(tolerance {TOL_ZOO_LOGITS})", flush=True)

    # Served through POST /predict.
    knobs = dict(ZOO2_TAGGER, max_epochs=3)
    worker = InferenceWorker(TorchTransformerTagger, knobs,
                             m.dump_parameters(), device="cuda").start()
    app = PredictorService([worker], device="cuda").start()
    try:
        queries = vds.sentences[:5] + [vds.sentences[5] * 3]
        status, resp, _ = post(app.url + "/predict", {"queries": queries})
        check(status == 200, f"/predict answered {status}")
        own = m.predict(queries)
    finally:
        app.stop()
        worker.stop()
    lens = [len(p) for p in resp["predictions"]]
    check(lens == [min(len(s), t) for s in queries],
          f"served lengths {lens}")
    err = max(float(np.abs(np.asarray(s, np.float64)
                           - np.asarray(o, np.float64)).max())
              for s, o in zip(resp["predictions"], own))
    check(err <= TOL_ENSEMBLE, f"served tagger distributions {err:.3e} off")
    print(f"zoo2: (e) 6 sentences served through POST /predict (lengths "
          f"{lens}): the model's own predict, max |diff| {err:.3e}; one "
          f"eager forward and backward {step_ms:.2f} ms (CUDA events) on "
          f"{card}", flush=True)
    m.destroy()
    torch.cuda.empty_cache()
    return ({"train_s": train_s, "steps_per_sec": steps / train_s,
             "tokens_per_sec": steps * b * t / train_s, "peak_gb": peak_gb,
             "val_acc": acc, "step_ms": step_ms,
             "busy_share": (prof[1] / 1e3 / step_ms) if prof else None,
             "block_err": block_err, "logit_err": logit_err,
             "served_err": err, "launches": got[:3], "kernels": kern},
            corpus)


class LifeFront:
    """Single-query ``POST /predict`` calls to one predictor, with or
    without the client header, each noted (status, with a header or
    not) for the workload and tenant checks."""

    def __init__(self, host):
        self.host = host
        self.lock = threading.Lock()
        self.statuses = []
        self.with_header = 0

    def ask(self, queries, tenant=None, single=True):
        """``(status, raw body, predictions, seconds)``."""
        from rafiki_torch.cache import encode_payload

        body = ({"query": encode_payload(queries)} if single else
                {"queries": [encode_payload(q) for q in queries]})
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers[LIFE_HEADER] = tenant
        req = urllib.request.Request(f"http://{self.host}/predict",
                                     data=json.dumps(body).encode(),
                                     headers=headers, method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                status, raw = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        dt = time.perf_counter() - t0
        with self.lock:
            self.statuses.append(status)
            self.with_header += bool(tenant)
        out = json.loads(raw) if status == 200 else {}
        return status, raw, out.get("prediction", out.get("predictions")), dt


def life_load(np, front, imgs, tenants, stop):
    """``len(tenants)`` clients sending single images from ``imgs`` until
    ``stop`` is set; returns the executor and its futures (statuses)."""
    from concurrent.futures import ThreadPoolExecutor

    def loop(i):
        rng = np.random.default_rng(SEED + i)
        got = []
        while not stop.is_set():
            got.append(front.ask(imgs[int(rng.integers(len(imgs)))],
                                 tenants[i])[0])
        return got

    pool = ThreadPoolExecutor(len(tenants))
    return pool, [pool.submit(loop, i) for i in range(len(tenants))]


def wait_for(cond, secs, msg):
    deadline = time.monotonic() + secs
    while not cond():
        check(time.monotonic() < deadline, msg)
        time.sleep(0.02)


def series(metrics, name, key, **match):
    """``{label value: sample}`` of one family, filtered by labels."""
    fam = metrics.registry().find(name)
    out = {}
    for labels, v in (fam.samples() if fam is not None else ()):
        if all(labels.get(k) == w for k, w in match.items()):
            out[labels[key]] = out.get(labels[key], 0.0) + v
    return out


def lifecycle_phase(torch, np, attn, card, zoo2):
    """The serving lifecycle on the card, driven through the admin REST
    service and the predictor: zoo2 (b)'s 4 ViT trials written into a
    ``LocalPlatform``'s stores, the 2 best deployed (one worker, a
    stacked 2-member bin), then (a) the edge cache, (b) a surgical
    promote under load, (c) an additive promote with a pipelined
    worker, (d) tiering over the two bins, (e) the workload records and
    tenant series, (f) a drain under load. Returns the phase's numbers
    and K1-K3 launches."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch.cache import Cache, PackedBatch
    from rafiki_torch.client import Client
    from rafiki_torch.constants import ServiceStatus, ServiceType, TaskType
    from rafiki_torch.models import TorchViT
    from rafiki_torch.observe import attribution, metrics, workload
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.worker.inference import prediction_confidence

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    trials = zoo2["lifecycle"]["trials"]
    imgs = zoo2["lifecycle"]["val"][0]
    check(len(trials) == ZOO2_VIT_TRIALS, f"{len(trials)} ViT trials")
    out = {}

    def own(knobs, p):
        m = TorchViT(device="cuda", **TorchViT.validate_knobs(knobs))
        m.load_parameters(p)
        return m

    env = {"RAFIKI_TPU_SERVING_CACHE_BYTES": str(LIFE_CACHE_BYTES),
           "RAFIKI_TPU_SERVING_ATTRIBUTION": "1",
           "RAFIKI_TPU_WORKLOAD_RECORD": "1",
           "RAFIKI_TPU_SERVING_CLIENT_HEADER": LIFE_HEADER}
    saved = {k: os.environ.get(k)
             for k in list(env) + ["RAFIKI_TPU_SERVING_PIPELINE",
                                   "RAFIKI_TPU_SERVING_TIER_THRESHOLD"]}
    os.environ.update(env)
    os.environ.pop("RAFIKI_TPU_SERVING_PIPELINE", None)
    # The ledger and the recorder read their switches once a process.
    attribution.reset_for_tests()
    workload.reset_for_tests()
    plat = LocalPlatform(http=True, supervise_interval=0)
    tenants = [f"client-{i}" for i in range(LIFE_CLIENTS)]
    try:
        root = plat.meta.get_user_by_email("superadmin@rafiki")
        model = plat.admin.create_model(root["id"], "vit-life",
                                        TaskType.IMAGE_CLASSIFICATION,
                                        "rafiki_torch.models.vit:TorchViT")
        job = plat.meta.create_train_job(root["id"], "vit-life",
                                         TaskType.IMAGE_CLASSIFICATION, {},
                                         "-", "-", "STOPPED")
        sub = plat.meta.create_sub_train_job(job["id"], model["id"],
                                             "STOPPED")
        tids = []
        for i, (knobs, p, score) in enumerate(trials):
            t = plat.meta.create_trial(sub["id"], model["id"], i + 1,
                                       "RUNNING", knobs=knobs)
            plat.meta.mark_trial_completed(
                t["id"], score, plat.params.save(p, session_id="life"))
            tids.append(t["id"])
        order = [t["id"] for t in plat.meta.get_best_trials_of_train_job(
            job["id"], max_count=len(tids))]
        # The tier threshold, before the deploy reads it: the median
        # softmax margin of the best trial's rows over (d)'s images,
        # averaged with the trial that will share its bin then (the
        # third best, after the surgical promote), since the best bin
        # answers with their mean.
        d_imgs = imgs[256:256 + LIFE_TIER]
        with uncounted(attn):
            pair = [own(*trials[tids.index(t)][:2])
                    for t in (order[0], order[2])]
            rows0 = np.mean([in_bursts(np, lambda x, m=m: member_rows(
                np, m, x), d_imgs, 64).astype(np.float64)
                for m in pair], axis=0)
            for m in pair:
                m.destroy()
        threshold = float(np.median([prediction_confidence(r)
                                     for r in rows0]))
        os.environ["RAFIKI_TPU_SERVING_TIER_THRESHOLD"] = repr(threshold)
        client = Client(admin_port=plat.admin_port)
        client.login("superadmin@rafiki", "rafiki")
        t0 = time.perf_counter()
        inf = client.create_inference_job(job["id"], max_models=2)
        cache = Cache(plat.bus)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 1, 300,
                 "the stacked ViT worker did not register")
        deploy_s = time.perf_counter() - t0
        (sid1, reg1), = cache.running_worker_info(inf["id"]).items()
        members = reg1["trial_id"].split(",")
        check(reg1["stacked"] is True and sorted(members) ==
              sorted(order[:2]), f"the deploy registered {reg1}")
        weaker = max(members, key=order.index)
        incoming, additive = [t for t in order if t not in members]
        check(incoming == order[2], "the bin is not the 2 best trials")
        worker1 = plat.container.get(sid1)
        ens, st = worker1.model, worker1.model.stacked
        pred_row = next(s for s in plat.meta.get_services()
                        if s["service_type"] == ServiceType.PREDICT)
        psvc = plat.container.get(pred_row["id"])
        psvc.predictor.gather_timeout = LIFE_GATHER_TIMEOUT
        host = client.get_inference_job(inf["id"])["predictor_host"]
        front = LifeFront(host)

        def events():
            return dict(psvc.edge_cache.info().get("events", {}))

        def bursts():
            return sum(ens.bursts.values())

        def rnd(xs):
            with ThreadPoolExecutor(LIFE_CLIENTS) as pool:
                return list(pool.map(
                    lambda ix: front.ask(ix[1], tenants[ix[0] % len(
                        tenants)]), enumerate(xs)))

        # (a) The edge cache.
        t0 = time.perf_counter()
        a_imgs = imgs[:LIFE_IMAGES]
        r1, r2 = rnd(a_imgs), rnd(a_imgs)
        ev2, b2 = events(), bursts()
        hits0 = stats_of(host)["cache"]["events"].get("hit", 0)
        r3 = rnd(a_imgs)
        ev3, b3 = events(), bursts()
        hits = stats_of(host)["cache"]["events"].get("hit", 0) - hits0
        check(all(r[0] == 200 for r in r1 + r2 + r3),
              "an (a) request failed")
        check([r[1] for r in r3] == [r[1] for r in r2],
              "the third round's answers are not the second's bytes")
        check(hits == LIFE_IMAGES and b3 == b2,
              f"(a) third round: {hits} hits in /stats, bursts {b2} -> {b3}")
        x_new = imgs[LIFE_IMAGES]
        gate = threading.Event()
        submit = ens.predict_staged_submit

        def held(buf, n):
            # The leader is held in the worker until its copies wait on
            # it: a slow model, made on purpose.
            gate.wait(30)
            return submit(buf, n)

        c0, b0 = events().get("coalesce", 0), bursts()
        ens.predict_staged_submit = held
        try:
            with ThreadPoolExecutor(LIFE_COALESCE) as pool:
                futs = [pool.submit(front.ask, x_new,
                                    tenants[i % len(tenants)])
                        for i in range(LIFE_COALESCE)]
                wait_for(lambda: events().get("coalesce", 0) - c0
                         >= LIFE_COALESCE - 1, 30,
                         "the copies did not coalesce")
                gate.set()
                co = [f.result() for f in futs]
        finally:
            gate.set()
            del ens.predict_staged_submit
        coalesced = events().get("coalesce", 0) - c0
        check(all(r[0] == 200 for r in co) and len({r[1] for r in co}) == 1
              and bursts() - b0 == 1, f"(a) {LIFE_COALESCE} copies: "
              f"{bursts() - b0} bursts, {coalesced} coalesced")
        a_s = time.perf_counter() - t0
        print(f"lifecycle: (a) {LIFE_IMAGES} distinct images three times "
              f"from {LIFE_CLIENTS} clients: round 3 answered {hits} from "
              f"the cache (/stats), byte for byte round 2's answers, the "
              f"worker's bursts {b2} -> {b3} across it; events after round "
              f"3 {ev3}; {LIFE_COALESCE} concurrent copies of one new "
              f"image cost {bursts() - b0} burst, {coalesced} coalesced; "
              f"took {a_s:.1f} s on {card}", flush=True)
        out["cache"] = {"hits": hits, "coalesced": coalesced,
                        "events": ev3}

        # (b) The surgical promote, under load.
        t0 = time.perf_counter()
        stop = threading.Event()
        pool, futs = life_load(np, front, imgs[128:256], tenants, stop)
        time.sleep(1.0)
        restack = {}
        apply_restack = worker1._restack_member

        def traced(req):
            n0, c0_ = attn.flash_attention.launches, st.captures
            apply_restack(req)
            restack.update(k1=attn.flash_attention.launches - n0,
                           captures=st.captures - c0_)

        worker1._restack_member = traced
        n_services = len(plat.meta.get_services())
        epoch0 = psvc.edge_cache.info()["epoch"]
        tp = time.perf_counter()
        status, res = life_promote(plat.admin_port, client._token,
                                   inf["id"], incoming, weaker)
        promote_s = time.perf_counter() - tp
        time.sleep(0.5)
        stop.set()
        load = [s_ for f in futs for s_ in f.result()]
        pool.shutdown()
        del worker1._restack_member
        check(status == 200 and res.get("restacked_service_ids") == [sid1]
              and res.get("new_service_id") is None,
              f"the surgical promote answered {status} {res}")
        check(len(load) > 0 and all(s_ == 200 for s_ in load),
              f"(b) load: {len(load)} requests, statuses "
              f"{sorted(set(load))}")
        check(len(plat.meta.get_services()) == n_services,
              "the surgical promote started a service")
        check(restack == {"k1": 0, "captures": 0},
              f"the restack launched K1 or captured: {restack}")
        reg1b = cache.running_worker_info(inf["id"])[sid1]
        check(sorted(reg1b["trial_id"].split(",")) ==
              sorted([m for m in members if m != weaker] + [incoming]),
              f"the registration after the restack: {reg1b}")
        e0 = events()
        status, _, _, _ = front.ask(a_imgs[0], tenants[0])
        e1 = events()
        epoch1 = psvc.edge_cache.info()["epoch"]
        check(status == 200 and e1.get("miss", 0) - e0.get("miss", 0) == 1
              and e1.get("hit", 0) == e0.get("hit", 0)
              and epoch1 > epoch0 and e1.get("invalidate", 0) >= 1,
              f"a repeat after the promote: events {e0} -> {e1}, epoch "
              f"{epoch0} -> {epoch1}")
        worst = 0.0
        for i, n in enumerate((1, 2, 3, 5, 8)):
            x = imgs[600 + 8 * i:600 + 8 * i + n]
            status, _, served, _ = front.ask(list(x), single=False)
            check(status == 200, f"a request of {n} answered {status}")
            rows_ = stacked_rows(np, st, x).astype(np.float64).mean(0)
            worst = max(worst, float(np.abs(np.asarray(served)
                                            - rows_).max()))
        check(worst <= TOL_ENSEMBLE, f"served answers after the restack "
              f"differ from the restacked rows' mean by {worst:.3e}")
        j = reg1b["trial_id"].split(",").index(incoming)
        with uncounted(attn):
            m3 = own(*trials[tids.index(incoming)][:2])
            rows_st = in_bursts(np, lambda x: stacked_rows(np, st, x),
                                imgs[:64], 8)
            rows_own = in_bursts(np, lambda x: member_rows(np, m3, x),
                                 imgs[:64], 8)
            m3.destroy()
        dp = float(np.abs(rows_st[j] - rows_own).max())
        check(dp <= TOL_STACKED_FF, f"the restacked member's rows differ "
              f"from its own TorchViT's by {dp:.3e}")
        b_s = time.perf_counter() - t0
        print(f"lifecycle: (b) surgical promote (trial "
              f"{tids.index(incoming) + 1} in place of trial "
              f"{tids.index(weaker) + 1}) through POST "
              f"/inference_jobs/<id>/promote in {promote_s * 1e3:.1f} ms "
              f"while {LIFE_CLIENTS} clients sent {len(load)} requests, "
              f"all 200; no new service; K1 launches and captures during "
              f"the restack {restack}; the repeat of an (a) image missed "
              f"(epoch {epoch0} -> {epoch1}, invalidate "
              f"{e1.get('invalidate')}); served = mean of the restacked "
              f"rows, max |diff| {worst:.3e} (tolerance {TOL_ENSEMBLE}); "
              f"the new member's stacked rows against its own TorchViT "
              f"over 64 images max |dp| {dp:.3e} (tolerance "
              f"{TOL_STACKED_FF}); took {b_s:.1f} s on {card}", flush=True)
        out["surgical"] = {"promote_ms": promote_s * 1e3, "load": len(load),
                           "restack": restack, "served_err": worst,
                           "member_dp": dp}

        # (c) The additive promote; the incoming worker pipelined.
        t0 = time.perf_counter()
        n1 = launch_counts(attn)
        os.environ["RAFIKI_TPU_SERVING_PIPELINE"] = "1"
        try:
            status, res = life_promote(plat.admin_port, client._token,
                                       inf["id"], additive)
        finally:
            os.environ.pop("RAFIKI_TPU_SERVING_PIPELINE", None)
        n2 = launch_counts(attn)
        check(status == 200 and res.get("new_service_id"),
              f"the additive promote answered {status} {res}")
        sid2 = res["new_service_id"]
        info = cache.running_worker_info(inf["id"])
        reg2 = info.get(sid2) or {}
        check(len(info) == 2 and reg2.get("pipeline") is True
              and reg2.get("trial_id") == additive,
              f"the second worker registered {reg2}")
        chips1 = plat.meta.get_service(sid1)["chips"]
        chips2 = plat.meta.get_service(sid2)["chips"]
        check(chips1 == chips2, f"the second worker is on chips {chips2}, "
              f"the first on {chips1}")
        k1_build, k1_wgmma = n2[0] - n1[0], n2[3] - n1[3]
        check(k1_build > 0 and k1_wgmma == k1_build,
              f"the second worker's runner builds launched K1 {k1_build} "
              f"times, {k1_wgmma} on wgmma")
        worker2 = plat.container.get(sid2)
        with uncounted(attn):
            m4 = own(*trials[tids.index(additive)][:2])
            for n in (1, 3, 8):
                x = imgs[700:700 + n]
                bid = cache.send_query_shards(
                    [(sid2, 0, n, "life")], None,
                    packed=PackedBatch.from_arrays(list(x)),
                    packed_ok={sid2})
                rep = cache.gather_prediction_batches(bid, 1, timeout=60)
                check(len(rep) == 1, f"the second worker did not answer "
                      f"{n} queries")
                got = np.asarray(rep[0]["predictions"], np.float64)
                want = member_rows(np, m4, x).astype(np.float64)
                check(np.array_equal(got, want), f"the pipelined worker's "
                      f"answers to {n} queries are not its trial's own "
                      f"rows: max |diff| {float(np.abs(got - want).max())}")
            m4.destroy()
        c_s = time.perf_counter() - t0
        print(f"lifecycle: (c) additive promote (trial "
              f"{tids.index(additive) + 1}) with "
              f"RAFIKI_TPU_SERVING_PIPELINE=1 for the incoming worker: a "
              f"second worker registered (pipeline={reg2['pipeline']}), "
              f"time-sliced on chips {chips2} with the first; its runner "
              f"builds launched K1 {k1_build} times, {k1_wgmma} on wgmma; "
              f"its answers to 1, 3 and 8 queries equal its trial's own "
              f"rows at the same bucket bit for bit. The first worker, "
              f"built without the variable: auto decision "
              f"pipeline={reg1['pipeline']} from a measured sync round "
              f"trip of {reg1['sync_latency_ms']} ms (threshold "
              f"{worker1.pipeline_sync_min * 1e3:.0f} ms); took "
              f"{c_s:.1f} s on {card}", flush=True)
        out["additive"] = {"k1_build": k1_build, "pipeline": True,
                           "auto_pipeline": reg1["pipeline"],
                           "sync_ms": reg1["sync_latency_ms"]}

        # (d) Tiering over the two bins.
        t0 = time.perf_counter()
        pred = psvc.predictor

        def tier_counts():
            return (series(metrics, "rafiki_tpu_serving_tier_total",
                           "outcome", service=pred.service),
                    series(metrics,
                           "rafiki_tpu_serving_chip_seconds_avoided_total",
                           "source", service=pred.service))

        (tier0, av0), e0 = tier_counts(), events()
        tw = time.perf_counter()
        d = rnd(d_imgs)
        secs = time.perf_counter() - tw
        (tier1, av1), e1 = tier_counts(), events()
        check(all(r[0] == 200 for r in d), "a (d) request failed")
        short = tier1.get("short_circuit", 0) - tier0.get("short_circuit", 0)
        esc = tier1.get("escalate", 0) - tier0.get("escalate", 0)
        avoided = av1.get("tier", 0.0) - av0.get("tier", 0.0)
        check(short + esc == LIFE_TIER and short > 0 and esc > 0
              and avoided > 0, f"(d) tier outcomes: {short} short circuits, "
              f"{esc} escalations, {avoided} chip-seconds avoided")
        weight = int(ens.last_weight)
        with uncounted(attn):
            best_rows = {b: in_bursts(np, lambda x: stacked_rows(
                np, st, x).astype(np.float64).mean(0), d_imgs, b)
                for b in LIFE_BUCKETS}
            other_rows = {b: in_bursts(np, lambda x: member_rows(
                np, worker2.model, x).astype(np.float64), d_imgs, b)
                for b in LIFE_BUCKETS}
        worst, matched = 0.0, {"short_circuit": 0, "escalate": 0}
        for i, r in enumerate(d):
            got = np.asarray(r[2], np.float64)
            errs = {("short_circuit", b): float(np.abs(
                got - best_rows[b][i]).max()) for b in LIFE_BUCKETS}
            errs.update({("escalate", b1, b2): float(np.abs(
                got - np.average([best_rows[b1][i], other_rows[b2][i]],
                                 axis=0, weights=[weight, 1])).max())
                for b1 in LIFE_BUCKETS for b2 in LIFE_BUCKETS})
            kind = min(errs, key=errs.get)
            worst = max(worst, errs[kind])
            matched[kind[0]] += 1
        check(worst <= TOL_ENSEMBLE, f"(d) answers differ from the bins' "
              f"rows by {worst:.3e}")
        lat = sorted(r[3] for r in d)
        d_s = time.perf_counter() - t0
        print(f"lifecycle: (d) tiering (threshold {threshold:.4f}, the "
              f"median softmax margin of the best trial's rows averaged "
              f"with its bin partner's) over the 2 bins: {LIFE_TIER} "
              f"single images from {LIFE_CLIENTS} "
              f"clients, {LIFE_TIER / secs:.2f} queries/s, latency p50 "
              f"{percentile(lat, 50) * 1e3:.2f} ms, p99 "
              f"{percentile(lat, 99) * 1e3:.2f} ms; cache hits "
              f"{e1.get('hit', 0) - e0.get('hit', 0)}; {short} short "
              f"circuits and {esc} escalations (matched {matched}), "
              f"{avoided:.6f} chip-seconds avoided (tier); every answer "
              f"within {worst:.3e} of the best bin's vote alone or of the "
              f"weighted mean of both bins' rows taken directly "
              f"(tolerance {TOL_ENSEMBLE}); took {d_s:.1f} s on {card}",
              flush=True)
        out["tier"] = {"threshold": threshold, "qps": LIFE_TIER / secs,
                       "p50_ms": percentile(lat, 50) * 1e3,
                       "p99_ms": percentile(lat, 99) * 1e3,
                       "short_circuit": short, "escalate": esc,
                       "avoided_s": avoided, "err": worst}

        # (e) The workload records and the tenant series.
        recs = workload.load(plat.services.log_dir)
        with front.lock:
            sent, with_header = list(front.statuses), front.with_header
        by_status = sorted(r["status"] for r in recs)
        check(len(recs) == len(sent) and by_status == sorted(sent),
              f"{len(recs)} workload records for {len(sent)} requests")
        admitted = series(metrics, "rafiki_tpu_serving_tenant_requests_total",
                          "tenant")
        device = series(metrics,
                        "rafiki_tpu_serving_tenant_device_seconds_total",
                        "tenant")
        check(sum(admitted.values()) == with_header
              and len(admitted) == len(tenants)
              and set(device) == set(admitted)
              and min(device.values()) > 0,
              f"tenants: {admitted} requests, {device} device seconds, "
              f"{with_header} requests sent with the header")
        print(f"lifecycle: (e) {len(recs)} workload records for the "
              f"{len(sent)} requests the phase sent through the front "
              f"(statuses {sorted(set(by_status))}); {len(admitted)} "
              f"tenants, admitted requests summing to {with_header} (the "
              f"requests sent with {LIFE_HEADER}), device seconds each "
              f"{min(device.values()):.6f} to {max(device.values()):.6f}",
              flush=True)
        out["records"] = {"n": len(recs), "tenants": len(admitted)}

        # (f) Drain the additive worker under load.
        t0 = time.perf_counter()
        stop = threading.Event()
        pool, futs = life_load(np, front, imgs[512:640], tenants, stop)
        time.sleep(0.5)
        drain = plat.services.drain_inference_worker(sid2)
        time.sleep(0.5)
        stop.set()
        load = [s_ for f in futs for s_ in f.result()]
        pool.shutdown()
        row2 = plat.meta.get_service(sid2)
        check(drain["drained"] and row2["status"] == ServiceStatus.STOPPED
              and all(s_ == 200 for s_ in load) and len(load) > 0,
              f"(f) drain {drain}, the worker {row2['status']}, load "
              f"statuses {sorted(set(load))} of {len(load)}")
        check(sid2 not in cache.running_workers(inf["id"]),
              "the drained worker is still registered")
        f_s = time.perf_counter() - t0
        print(f"lifecycle: (f) drained the additive worker while "
              f"{LIFE_CLIENTS} clients sent {len(load)} requests, all 200; "
              f"it exited {row2['status']} (drained={drain['drained']}); "
              f"took {f_s:.1f} s on {card}", flush=True)
        client.stop_inference_job(inf["id"])
    finally:
        plat.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        attribution.reset_for_tests()
        workload.reset_for_tests()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(launches[0] > 0 and launches[3] == launches[0],
          f"the lifecycle phase launched K1 {launches[0]} times, "
          f"{launches[3]} on wgmma")
    check(phase_s <= LIFE_MAX_S, f"the lifecycle phase took {phase_s:.1f} s")
    print(f"lifecycle: K1, K2 and K3 launched {launches[:3]} times in the "
          f"phase (counted by the wrappers: runner builds; replays run "
          f"uncounted), all K1 on wgmma; deploy to registration "
          f"{deploy_s:.1f} s; phase took {phase_s:.1f} s", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def life_promote(port, token, job_id, trial_id, replace=None):
    """``POST /inference_jobs/<job_id>/promote``: ``(status, body)``."""
    body = {"trial_id": trial_id}
    if replace is not None:
        body["replace_trial_id"] = replace
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/inference_jobs/{job_id}/promote",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {token}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class MfuPoller:
    """``GET /status`` every ``TENANT_POLL_S`` on its own thread, keeping
    each non-empty ``mfu`` reading with its time."""

    def __init__(self, port, token):
        self.url = f"http://127.0.0.1:{port}/status"
        self.token = token
        self.readings = []
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            req = urllib.request.Request(
                self.url, headers={"Authorization": f"Bearer {self.token}"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    mfu = json.loads(r.read())["mfu"]
            except (OSError, ValueError) as e:
                self.errors.append(repr(e))
                mfu = {}
            if mfu:
                self.readings.append((time.time(), mfu))
            self._stop.wait(TENANT_POLL_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def traced_ask(host, image):
    """One single-image ``POST /predict`` sent without a trace id:
    ``(status, seconds, the X-Trace-Id the edge minted or None)``."""
    from rafiki_torch.cache import encode_payload

    req = urllib.request.Request(
        f"http://{host}/predict",
        data=json.dumps({"query": encode_payload(image)}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            r.read()
            status, tid = r.status, r.headers.get("X-Trace-Id")
    except urllib.error.HTTPError as e:
        e.read()
        status, tid = e.code, e.headers.get("X-Trace-Id")
    return status, time.perf_counter() - t0, tid


def load_window(np, host, imgs, stop):
    """``TENANT_CLIENTS`` clients sending single images until ``stop``
    is set; returns the pool and the futures of their (status, seconds)
    lists."""
    from concurrent.futures import ThreadPoolExecutor

    def loop(i):
        rng = np.random.default_rng(SEED + 100 + i)
        got = []
        while not stop.is_set():
            status, dt, _ = traced_ask(host, imgs[int(rng.integers(
                len(imgs)))])
            got.append((status, dt))
        return got

    pool = ThreadPoolExecutor(TENANT_CLIENTS)
    return pool, [pool.submit(loop, i) for i in range(TENANT_CLIENTS)]


def trace_naming(paths, *needles):
    """The first Chrome trace file among ``paths`` whose device kernel
    events name each of ``needles``, with one such name a needle; else
    ``(None, [])``. A file is parsed only when its bytes hold them all."""
    for path in paths:
        with open(path, "rb") as f:
            raw = f.read()
        if not all(n.encode() in raw for n in needles):
            continue
        names = {e.get("name", "") for e in json.loads(raw).get(
            "traceEvents", []) if e.get("cat") == "kernel"}
        found = [next((x for x in names if n in x), None) for n in needles]
        if all(found):
            return path, found
    return None, []


def tenants_phase(torch, np, attn, card, vit_data=None):
    """BASELINE config 5 on the card through the observability plane: two
    tenants' train jobs time-sliced on one card (trials/hour, per-job
    seconds, fairness, overlap, the /status MFU gauges, /trial_phases,
    the trials' device traces), then the ViT job served and profiled
    under load through ``POST /inference_jobs/<id>/profile``, then a
    window of tail-sampled traces held against their verdicts, the
    span store and the exemplars. ``vit_data`` is the ViT job's (train,
    val) paths, the zoo2 phase's set; None makes the same set anew.
    Returns the phase's numbers and K1-K3 launches."""
    import glob
    import os
    import re
    import tempfile

    from rafiki_torch.cache import Cache
    from rafiki_torch.client import Client
    from rafiki_torch.constants import (BudgetOption, TaskType,
                                        TrialStatus, UserType)
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.observe import metrics, profiling, trace
    from rafiki_torch.platform import LocalPlatform

    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory()
    trace_root = os.path.join(tmp.name, "traces")
    env = {trace.TRACE_TAIL_SAMPLE_ENV: repr(TENANT_TAIL_SAMPLE),
           profiling.TRACE_DIR_ENV: trace_root,
           "RAFIKI_TPU_METRICS_EXEMPLARS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # Each session's stop and write, timed where the port does them.
    stops = []
    stop_profiler = profiling._stop_profiler

    def timed_stop(prof, out_dir):
        got = stop_profiler(prof, out_dir)
        stops.append((out_dir,) + got)
        return got

    profiling._stop_profiler = timed_stop
    # Switches read once a process, read again for this phase.
    metrics.reset_exemplars_for_tests()
    trace.reset_tail_for_tests()
    plat = None
    try:
        t0 = time.perf_counter()
        sets = {"vit": vit_data or make_synthetic_image_dataset(
                    tmp.name, seed=SEED, **ZOO_DATA),
                "ff": make_synthetic_image_dataset(tmp.name, seed=SEED,
                                                   **TENANT_FF_DATA)}
        vds = load_image_dataset(sets["vit"][1])
        imgs = vds.images[:256]
        print(f"tenants: the ViT job on the zoo phases' synthetic "
              f"CIFAR-10-shaped set ({ZOO_DATA['n_train']} + {vds.size} "
              f"images{', made anew' if vit_data is None else ''}), the "
              f"feed-forward job on {TENANT_FF_DATA['n_train']} + "
              f"{TENANT_FF_DATA['n_val']} images made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        plat = LocalPlatform(http=True, supervise_interval=0)
        port = plat.admin_port
        root = Client(admin_port=port)
        root.login("superadmin@rafiki", "rafiki")
        specs = (("ff", "rafiki_torch.models.feedforward:TorchFeedForward",
                  None), ("vit", "TenantViT", TENANT_VIT_SOURCE))
        tenants = []
        for i, (name, cls, src) in enumerate(specs):
            root.create_user(f"tenant{i}@rafiki", "rafiki",
                             UserType.MODEL_DEVELOPER)
            c = Client(admin_port=port)
            c.login(f"tenant{i}@rafiki", "rafiki")
            model = c.create_model(f"tenant-{name}",
                                   TaskType.IMAGE_CLASSIFICATION, cls,
                                   model_source=src)
            tenants.append((name, c, model))
        phases0 = root._call("GET", "/trial_phases")["phases"]
        traces0 = series(metrics, "rafiki_tpu_trial_traces_total", "event")
        reset_launch_counts(attn)

        # The two jobs, submitted together.
        t0 = time.perf_counter()
        jobs = {}
        with MfuPoller(port, root._token) as poller:
            for name, c, model in tenants:
                jobs[name] = c.create_train_job(
                    f"tenant-{name}", TaskType.IMAGE_CLASSIFICATION,
                    [model["id"]],
                    {BudgetOption.MODEL_TRIAL_COUNT: TENANT_TRIALS,
                     BudgetOption.CHIP_COUNT: 1}, *sets[name],
                    advisor_type="random")
            owners = [list(o) for o in plat.allocator._owners]
            for name, c, _ in tenants:
                done = c.wait_until_train_job_done(jobs[name]["id"],
                                                   timeout=600, poll=0.2)
                check(done["status"] == "STOPPED",
                      f"the {name} job ended {done['status']}")
            train_s = time.perf_counter() - t0
        launches = launch_counts(attn)
        check(len(plat.allocator._owners) == 1 and len(owners[0]) == 2,
              f"the jobs did not share the one card: owners {owners}")
        rows, windows = {}, {}
        for name, c, _ in tenants:
            rows[name] = c.get_trials_of_train_job(jobs[name]["id"])
            check(len(rows[name]) == TENANT_TRIALS and all(
                r["status"] == TrialStatus.COMPLETED for r in rows[name]),
                f"the {name} job's trials: "
                f"{[r['status'] for r in rows[name]]}")
            full = plat.meta.get_trials_of_train_job(jobs[name]["id"])
            windows[name] = (min(t["started_at"] for t in full),
                             max(t["finished_at"] for t in full))
        (a0, a1), (b0, b1) = windows["ff"], windows["vit"]
        overlap = min(a1, b1) - max(a0, b0)
        check(overlap > 0, f"the jobs ran one after the other: {windows}")
        per_job = {k: w[1] - w[0] for k, w in windows.items()}
        fairness = min(per_job.values()) / max(per_job.values())
        n_trials = 2 * TENANT_TRIALS
        tph = n_trials * 3600 / train_s
        check(launches[0] > 0 and launches[1] > 0 and launches[2] > 0
              and launches[3:] == launches[:3],
              f"the ViT job launched K1-K3 {launches[:3]}, on wgmma "
              f"{launches[3:]}")
        print(f"tenants: 2 jobs of {TENANT_TRIALS} trials (TorchFeedForward "
              f"and ViT d_model 128, 4 heads of 32, 65 tokens, 6 blocks, "
              f"batch 256, one epoch), CHIP_COUNT 1 each, time-sliced on "
              f"the one card (owners {owners[0]}): {n_trials} trials in "
              f"{train_s:.2f} s = {tph:.1f} trials/hour; per-job seconds "
              f"ff {per_job['ff']:.2f}, vit {per_job['vit']:.2f}, fairness "
              f"(min/max) {fairness:.3f}; the windows overlapped "
              f"{overlap:.2f} s; K1, K2, K3 launches {launches[:3]}, all "
              f"on wgmma, on {card}", flush=True)
        for name in ("ff", "vit"):
            for r in rows[name]:
                print(f"tenants: {name} trial {r['no']}: knobs "
                      f"{json.dumps(r['knobs'])}, val accuracy "
                      f"{r['score']:.4f}", flush=True)

        # The /status MFU gauges, read while the trials ran (a model
        # trained outside a trial earlier in the process leaves an
        # unlabelled series, as the reference's does: not this phase's).
        vit_ids = {r["id"][:12] for r in rows["vit"]}
        ours = vit_ids | {r["id"][:12] for r in rows["ff"]}
        readings = [{k: v for k, v in m.items() if k in ours}
                    for _, m in poller.readings]
        readings = [m for m in readings if m]
        vit_vals = [v for m in readings for k, v in m.items()
                    if k in vit_ids]
        sums = [sum(m.values()) for m in readings]
        both = [m for m in readings if len(m) == 2 and set(m) & vit_ids]
        check(vit_vals and all(0 < v <= 1 for v in vit_vals),
              f"/status mfu while the ViT trials ran: {vit_vals[:8]} "
              f"({len(readings)} readings of this phase's trials, poll "
              f"errors {poller.errors[:3]})")
        after = root._call("GET", "/status")["mfu"]
        check(not set(after) & ours, f"/status mfu after the trials: "
              f"{after}")
        print(f"tenants: /status mfu every {TENANT_POLL_S * 1e3:.0f} ms: "
              f"{len(readings)} readings of this phase's trials; the ViT "
              f"trials' "
              f"{len(vit_vals)} readings {min(vit_vals, default=0):.4f} to "
              f"{max(vit_vals, default=0):.4f}; both tenants at once in "
              f"{len(both)} readings; the sum of one reading up to "
              f"{max(sums, default=0):.4f} (each trial's gauge counts its "
              f"own steps, so the card's MFU is their sum); none of "
              f"them after the trials (other series: {after})", flush=True)

        # /trial_phases.
        phases1 = root._call("GET", "/trial_phases")
        counts = {p: phases1["phases"][p]["count"] - phases0[p]["count"]
                  for p in phases1["phases"]}
        check(all(counts[p] == n_trials
                  for p in ("propose", "train", "eval", "persist")),
              f"/trial_phases counted {counts} for {n_trials} trials")
        print(f"tenants: GET /trial_phases: {json.dumps(phases1)}; this "
              f"phase's counts {counts}", flush=True)

        # The trials' device traces.
        traces1 = series(metrics, "rafiki_tpu_trial_traces_total", "event")
        ev = {e: traces1.get(e, 0.0) - traces0.get(e, 0.0)
              for e in ("start", "busy")}
        files = sorted(glob.glob(os.path.join(trace_root, "*",
                                              "*.pt.trace.json")))
        check(ev["start"] >= 1 and ev["start"] + ev["busy"] == n_trials
              and len(files) == ev["start"],
              f"trial traces: {ev}, {len(files)} files for {n_trials} "
              f"trials")
        path, names = trace_naming(files, "flash_bwd_dq_wgmma",
                                   "flash_bwd_dkv_wgmma")
        check(path is not None, f"no trial trace of {len(files)} names "
              f"K2's and K3's kernels among its device events")
        tid = os.path.basename(os.path.dirname(path))
        whose = "vit" if tid[:12] in vit_ids else "ff"
        print(f"tenants: {len(files)} trials traced into "
              f"RAFIKI_TPU_TRACE_DIR, {ev['busy']:.0f} skipped for a busy "
              f"profiler (counted, every trial COMPLETED); the {whose} "
              f"trial's trace ({os.path.getsize(path) / 2**20:.1f} MiB) "
              f"names {names[0][:60]} and {names[1][:60]} among its "
              f"device events; trace sizes "
              f"{[round(os.path.getsize(p) / 2**20, 1) for p in files]} "
              f"MiB; each trace's stop and write (s) "
              f"{[(round(a_, 2), round(b_, 2)) for _, _, a_, b_ in stops]}",
              flush=True)
        out.update(trials_per_hour=tph, per_job_s=per_job,
                   fairness=fairness, overlap_s=overlap,
                   train_launches=launches[:3],
                   mfu_vit_max=max(vit_vals, default=0),
                   mfu_sum_max=max(sums, default=0),
                   traced=ev["start"], busy=ev["busy"],
                   trace_mib=os.path.getsize(path) / 2**20)

        # The ViT job served; a window without, then with a profile.
        _, vit_client, _ = tenants[1]
        t0 = time.perf_counter()
        inf = vit_client.create_inference_job(jobs["vit"]["id"],
                                              max_models=2)
        cache = Cache(plat.bus)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 1, 300,
                 "the ViT job's worker did not register")
        (sid, reg), = cache.running_worker_info(inf["id"]).items()
        check(len(reg["trial_id"].split(",")) == 2,
              f"the ViT worker registered {reg}")
        host = vit_client.get_inference_job(inf["id"])["predictor_host"]
        deploy_s = time.perf_counter() - t0

        def window(profile_s=None):
            stop = threading.Event()
            pool, futs = load_window(np, host, imgs, stop)
            res = None
            try:
                time.sleep(0.3)
                if profile_s is None:
                    time.sleep(TENANT_WINDOW_S)
                else:
                    status, res = vit_client._send(
                        "POST", f"http://127.0.0.1:{port}/inference_jobs/"
                        f"{inf['id']}/profile", {"duration_s": profile_s},
                        {"Authorization": f"Bearer {vit_client._token}",
                         "Content-Type": "application/json"})[:2]
                    check(status == 200, f"the profile route answered "
                          f"{status} {res}")
                    wait_for(lambda: glob.glob(os.path.join(
                        res["profile_dir"], "*.pt.trace.json")), 120,
                        "the profile session wrote no trace")
                    time.sleep(0.3)
            finally:
                stop.set()
                got = [x for f in futs for x in f.result()]
                pool.shutdown()
            return got, res

        reset_launch_counts(attn)
        base, _ = window()
        name = "rafiki_tpu_profile_sessions_total"
        prof0 = series(metrics, name, "event")
        loaded, res = window(TENANT_PROFILE_S)
        prof1 = series(metrics, name, "event")
        serve_launches = launch_counts(attn)
        sess = {e: prof1.get(e, 0.0) - prof0.get(e, 0.0)
                for e in ("start", "busy", "stop")}
        for what, got in (("without", base), ("with", loaded)):
            check(got and all(s_ == 200 for s_, _ in got),
                  f"the window {what} the profile: statuses "
                  f"{sorted({s_ for s_, _ in got})} of {len(got)}")
        check(sess["start"] == 1 and sess["stop"] == 1 and sess["busy"] == 0,
              f"rafiki_tpu_profile_sessions_total moved {sess}")
        (ppath,) = glob.glob(os.path.join(res["profile_dir"],
                                          "*.pt.trace.json"))
        k1 = trace_naming([ppath], "flash_fwd_wgmma")[1]
        check(k1, "the profile's device events name no K1 kernel")
        lat_b = sorted(dt for _, dt in base)
        lat_p = sorted(dt for _, dt in loaded)
        print(f"tenants: the ViT job's 2 best as one worker (stacked: "
              f"{reg['stacked']}; deployed in {deploy_s:.1f} s); "
              f"{TENANT_CLIENTS} clients "
              f"of single images: without a profile {len(base)} requests, "
              f"p50 {percentile(lat_b, 50) * 1e3:.2f} ms, p99 "
              f"{percentile(lat_b, 99) * 1e3:.2f} ms; with POST "
              f"/inference_jobs/<id>/profile ({res['duration_s']} s) "
              f"{len(loaded)} requests, p50 "
              f"{percentile(lat_p, 50) * 1e3:.2f} ms, p99 "
              f"{percentile(lat_p, 99) * 1e3:.2f} ms, all 200; sessions "
              f"{sess}, its stop {stops[-1][2]:.3f} s and write "
              f"{stops[-1][3]:.3f} s on the serving thread; the trace "
              f"({os.path.getsize(ppath) / 2**20:.1f} "
              f"MiB) names {k1[0][:60]} among its device events; K1 "
              f"launched {serve_launches[0]} times in the deploy and the "
              f"windows ({serve_launches[3]} wgmma; replays run "
              f"uncounted) on {card}", flush=True)
        check(serve_launches[3] == serve_launches[0],
              f"the deploy's K1 launches {serve_launches[0]}, wgmma "
              f"{serve_launches[3]}")
        out.update(p99_ms={"without": percentile(lat_b, 99) * 1e3,
                           "with": percentile(lat_p, 99) * 1e3},
                   serve_launches=serve_launches[:3])

        # The tail-sampled window.
        from concurrent.futures import ThreadPoolExecutor

        trace.seed_tail(SEED)
        tail0 = series(metrics, "rafiki_tpu_trace_tail_total", "verdict")
        with ThreadPoolExecutor(TENANT_CLIENTS) as pool:
            sent = list(pool.map(lambda x: traced_ask(host, x),
                                 imgs[:TENANT_TRACED]))
        tail1 = series(metrics, "rafiki_tpu_trace_tail_total", "verdict")
        verdict_counts = {k: v - tail0.get(k, 0.0) for k, v in tail1.items()
                          if v - tail0.get(k, 0.0)}
        check(all(s_ == 200 and t_ for s_, _, t_ in sent),
              "a traced request failed or came back without X-Trace-Id")
        tids = [t_.split("-")[0] for _, _, t_ in sent]
        verdicts = {}
        with open(os.path.join(plat.services.log_dir,
                               trace.VERDICT_FILE)) as f:
            for line in f:
                rec = json.loads(line)
                verdicts.setdefault(rec["t"], []).append(rec["v"])
        check(all(len(verdicts.get(t_, [])) == 1 for t_ in tids),
              "a minted trace has not exactly one verdict line")
        kept = [t_ for t_ in tids if verdicts[t_] == ["kept"]]
        dropped = [t_ for t_ in tids if verdicts[t_] == ["dropped"]]
        spans = {t_: root._call("GET", f"/trace/{t_}")["n_spans"]
                 for t_ in tids}
        check(kept and dropped and all(spans[t_] >= 1 for t_ in kept)
              and all(spans[t_] == 0 for t_ in dropped),
              f"spans of kept traces {[spans[t_] for t_ in kept]}, of "
              f"dropped {[spans[t_] for t_ in dropped]}")
        with urllib.request.urlopen(f"http://{host}/metrics?exemplars=1",
                                    timeout=30) as r:
            expo = r.read().decode()
        ex_ids = set(re.findall(r'# \{trace_id="([0-9a-f]+)"\}', expo))
        all_dropped = {t_ for t_, v in verdicts.items() if "dropped" in v}
        ex_spans = {t_: root._call("GET", f"/trace/{t_}")["n_spans"]
                    for t_ in ex_ids}
        check(ex_ids and not ex_ids & all_dropped
              and all(n > 0 for n in ex_spans.values()),
              f"exemplars {len(ex_ids)}, of dropped traces "
              f"{len(ex_ids & all_dropped)}, spans {ex_spans}")
        print(f"tenants: {TENANT_TRACED} requests from {TENANT_CLIENTS} "
              f"clients under tail sampling at {TENANT_TAIL_SAMPLE} "
              f"(seed_tail({SEED})): one verdict line each; verdicts "
              f"{verdict_counts}; GET /trace/<id> gives "
              f"{min(spans[t_] for t_ in kept)} to "
              f"{max(spans[t_] for t_ in kept)} spans for the {len(kept)} "
              f"kept and none for the {len(dropped)} dropped; the "
              f"{len(ex_ids)} exemplars in GET /metrics all name kept "
              f"traces with spans", flush=True)
        out.update(verdicts=verdict_counts, kept=len(kept),
                   dropped=len(dropped), exemplars=len(ex_ids))
        vit_client.stop_inference_job(inf["id"])
    finally:
        if plat is not None:
            plat.shutdown()
        profiling._stop_profiler = stop_profiler
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        metrics.reset_exemplars_for_tests()
        trace.reset_tail_for_tests()
        tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= TENANT_MAX_S, f"the tenants phase took {phase_s:.1f} s")
    out.update(launches=tuple(a + b for a, b in zip(
        out["train_launches"], out["serve_launches"])), phase_s=phase_s)
    print(f"tenants: phase took {phase_s:.1f} s", flush=True)
    return out


class Child:
    """A child process of the processes phase in a session of its own, so
    a kill reaches what it started too; its merged output is read on a
    thread, and the lines that say what it did are printed."""

    SHOWN = ("rafiki-tpu ", "bus broker", "native broker", "attached ",
             "train job done", "inference job stopped", "timed out",
             "processes: child")

    def __init__(self, name, argv, env):
        self.name = name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            self.lines.append(line)
            if any(s in line for s in self.SHOWN):
                print(f"processes: [{self.name}] {line}", flush=True)

    def wait_line(self, text, secs):
        """The first output line holding ``text`` and the seconds since
        the child started; fails at ``secs`` or when the child exits
        without it."""
        deadline = time.monotonic() + secs
        while True:
            for line in list(self.lines):
                if text in line:
                    return line, time.perf_counter() - self.t0
            if self.proc.poll() is not None:
                self._reader.join(timeout=5)
                if not any(text in line for line in self.lines):
                    check(False, f"{self.name} exited "
                          f"{self.proc.returncode} before {text!r}: "
                          f"{self.lines[-30:]}")
            check(time.monotonic() < deadline,
                  f"{self.name}: no {text!r} within {secs} s: "
                  f"{self.lines[-30:]}")
            time.sleep(0.05)

    def wait(self, secs):
        try:
            rc = self.proc.wait(timeout=secs)
        except subprocess.TimeoutExpired:
            check(False, f"{self.name} did not exit within {secs} s: "
                  f"{self.lines[-30:]}")
        self._reader.join(timeout=5)
        return rc

    def signal(self, sig):
        import os

        try:
            os.killpg(self.proc.pid, sig)
        except ProcessLookupError:
            pass

    def stop(self):
        """SIGTERM to the session, SIGKILL to what is left after 20 s."""
        import signal

        if self.proc.poll() is None:
            self.signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                pass
        self.signal(signal.SIGKILL)
        self.proc.wait(timeout=20)
        self._reader.join(timeout=5)


def session_alive(pid):
    """Whether any process of the session led by ``pid`` is left."""
    import os

    try:
        os.killpg(pid, 0)
    except ProcessLookupError:
        return False
    return True


def ask(host, image, timeout):
    """One single-image ``POST /predict``: (status, seconds, answer); a
    transport failure is status 0."""
    from rafiki_torch.cache import encode_payload

    req = urllib.request.Request(
        f"http://{host}/predict",
        data=json.dumps({"query": encode_payload(image)}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = json.loads(r.read())
            return r.status, time.perf_counter() - t0, body["prediction"]
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, time.perf_counter() - t0, None
    except (OSError, ValueError):
        return 0, time.perf_counter() - t0, None


def processes_phase(torch, np, attn, card):
    """The node as processes on the one card: a broker child, a primary
    (``serve``) and two ``join`` children over the TCP bus, then a
    second inference job whose services are processes of their own.
    (a) the C++ broker built by g++ in its child; (b) a ViT job of 4
    trials through ``Client``; (c) a ``join`` child takes part: every
    trial COMPLETED, the trials' workers on two nodes, a join node's
    trial trace naming K1-K3's wgmma kernels; (d) the 2 best trials
    served by the primary and a replica in a third child: single queries
    bit for bit across the replicas and within TOL_PROB of the script's
    own forward, a 256-request window in which both replicas took
    shards; (e) the broker killed and restarted empty while a client
    sends: serving answers again within PROC_RECOVER_S; (f) a second
    inference job deployed through a ``ServicesManager`` on
    ``ProcessContainerManager``: its answers (d)'s bit for bit, no child
    alive after ``destroy_service``. No child outlives the phase.
    Returns the phase's numbers and the children's K1-K3 launches."""
    import glob
    import os
    import signal
    import socket
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch.admin import ServicesManager
    from rafiki_torch.bus import BusClient
    from rafiki_torch.cache import Cache, encode_payload
    from rafiki_torch.client import Client
    from rafiki_torch.constants import (BudgetOption, TaskType, TrialStatus,
                                        UserType)
    from rafiki_torch.container import ProcessContainerManager
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.observe import metrics
    from rafiki_torch.parallel.chips import ChipAllocator
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_proc_")
    root = tmp.name
    work = os.path.join(root, "work")
    site = os.path.join(root, "site")
    reports = os.path.join(root, "reports")
    traces = os.path.join(root, "traces")
    gate = os.path.join(root, "gate")
    for d in (site, reports):
        os.makedirs(d)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(PROC_SITE)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("RAFIKI_TPU_PLATFORM", None)  # unset: the card
    env["PYTHONPATH"] = os.pathsep.join(
        [site, repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    env.update({"RAFIKI_TPU_TRACE_DIR": traces,
                "RAFIKI_TPU_WORKER_REREGISTER": "1.0",
                PROC_REPORT_ENV: reports})
    children = []
    svc_procs = {}
    out = {}
    meta = services = None
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", PROC_REPORT_ENV,
                                            "RAFIKI_TPU_WORKER_REREGISTER")}

    def child(name, *args):
        c = Child(name, [sys.executable, "-m", "rafiki_torch", *args], env)
        children.append(c)
        return c

    try:
        # (a) and (b): the broker and the primary start together (a
        # node's bus client connects at its first operation).
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            bport = s_.getsockname()[1]
        uri = f"tcp://127.0.0.1:{bport}"
        broker = child("broker", "broker", "--port", str(bport))
        serve = child("serve", "serve", "--workdir", work, "--port", "0",
                      "--bus", uri)
        t0 = time.perf_counter()
        data = make_synthetic_image_dataset(root, seed=SEED, **PROC_DATA)
        vds = load_image_dataset(data[1])
        imgs = vds.images
        data_s = time.perf_counter() - t0
        line, broker_s = broker.wait_line("bus broker (", PROC_CHILD_S)
        built = [x for x in broker.lines if "native broker:" in x]
        check("NativeBusServer" in line and built,
              f"the broker child started {line!r} ({built})")
        plat_line, _ = serve.wait_line("rafiki-tpu platform:", PROC_CHILD_S)
        check(torch.cuda.get_device_name(0) in plat_line,
              f"the serve child printed {plat_line!r}")
        admin_line, serve_s = serve.wait_line("admin on http://",
                                              PROC_CHILD_S)
        port = int(re.search(r"http://[^:/]+:(\d+)", admin_line).group(1))
        print(f"processes: (a) broker child up in {broker_s:.2f} s "
              f"({built[0].split(': ', 1)[-1]}; {line.split('] ')[-1]}); "
              f"(b) serve child up in {serve_s:.2f} s on {card}; the "
              f"synthetic CIFAR-10-shaped set cut to "
              f"{PROC_DATA['n_train']} + {PROC_DATA['n_val']} images made "
              f"in {data_s:.2f} s", flush=True)

        # (b) the job, through Client; (c) a join child takes part.
        root_c = Client(admin_port=port)
        root_c.login("superadmin@rafiki", "rafiki")
        root_c.create_user("procs@rafiki", "rafiki",
                           UserType.MODEL_DEVELOPER)
        c = Client(admin_port=port)
        c.login("procs@rafiki", "rafiki")
        model = c.create_model("procs-vit", TaskType.IMAGE_CLASSIFICATION,
                               "ProcViT",
                               model_source=PROC_VIT_SOURCE.format(gate=gate))
        t_train = time.perf_counter()
        job = c.create_train_job(
            "procs-vit", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: PROC_TRIALS,
             BudgetOption.CHIP_COUNT: 1}, *data, advisor_type="random")
        joiner = child("join", "join", "--workdir", work, "--bus", uri,
                       "--train-job", job["id"], "--timeout", "300")
        _, join_s = joiner.wait_line("attached 1 worker", PROC_CHILD_S)
        meta = MetaStore(os.path.join(work, "meta.db"))
        sub = meta.get_sub_train_jobs(job["id"])[0]
        wait_for(lambda: len({t["worker_id"] for t in meta.get_trials(
            sub["id"])}) >= 2, PROC_CHILD_S,
            "the two nodes' workers did not both take a trial")
        open(gate, "w").close()
        check(joiner.wait(PROC_CHILD_S) == 0, f"the join child failed: "
              f"{joiner.lines[-30:]}")
        check(any("train job done" in x for x in joiner.lines),
              "the join child did not see the job done")
        done = c.wait_until_train_job_done(job["id"], timeout=PROC_CHILD_S,
                                           poll=0.2)
        train_s = time.perf_counter() - t_train
        check(done["status"] == "STOPPED", f"the job ended {done['status']}")
        rows = meta.get_trials_of_train_job(job["id"])
        check(len(rows) == PROC_TRIALS and all(
            r["status"] == TrialStatus.COMPLETED for r in rows),
            f"the job's trials: {[r['status'] for r in rows]}")
        node_of = {r["id"]: meta.get_service(r["worker_id"])["node_id"]
                   for r in rows}
        nodes = sorted(set(node_of.values()))
        check(len(nodes) == 2, f"the trials' workers span {nodes}")
        trial_s = {n: [round(r["finished_at"] - r["started_at"], 2)
                       for r in rows if node_of[r["id"]] == n]
                   for n in nodes}
        joined = [r for r in rows if "/join-" in node_of[r["id"]]]
        files = sorted(f for r in joined for f in glob.glob(os.path.join(
            traces, r["id"], "*.pt.trace.json")))
        path, names = trace_naming(files, "flash_fwd_wgmma",
                                   "flash_bwd_dq_wgmma",
                                   "flash_bwd_dkv_wgmma")
        check(path is not None, f"no trace of the join node's "
              f"{len(joined)} trials ({len(files)} files) names K1-K3's "
              f"wgmma kernels among its device events")
        with open(path) as f:
            events = [e.get("name", "") for e in json.load(f).get(
                "traceEvents", []) if e.get("cat") == "kernel"]
        trace_events = [sum(n in e for e in events) for n in names]
        print(f"processes: (c) join child attached in {join_s:.2f} s; "
              f"{PROC_TRIALS} ViT trials (d_model 128, 4 heads of 32, 65 "
              f"tokens, 6 blocks, batch 256, one epoch) in {train_s:.2f} s, "
              f"all COMPLETED, their seconds by node {trial_s} (a "
              f"trial's wait at the gate included); the join node's "
              f"trial trace "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) names "
              f"{[n[:48] for n in names]}, {trace_events} kernel events",
              flush=True)
        out.update(train_s=train_s, join_s=join_s, serve_s=serve_s,
                   broker_s=broker_s, trace_events=trace_events)

        # (d) the 2 best served by the primary and a replica child; (f)'s
        # job deployed meanwhile through ProcessContainerManager.
        t0 = time.perf_counter()
        inf = c.create_inference_job(job["id"], max_models=PROC_DEPLOY)
        replica = child("replica", "join", "--workdir", work, "--bus", uri,
                        "--inference-job", inf["id"], "--timeout", "600")
        user_id = meta.get_user_by_email("procs@rafiki")["id"]
        inf2 = meta.create_inference_job(user_id, job["id"], "STARTED")
        os.environ.update(PYTHONPATH=env["PYTHONPATH"],
                          RAFIKI_TPU_WORKER_REREGISTER="1.0",
                          **{PROC_REPORT_ENV: reports})
        services = ServicesManager(
            meta, ProcessContainerManager(), ChipAllocator(1),
            "smoke/processes", log_dir=os.path.join(work, "logs"),
            meta_uri=os.path.join(work, "meta.db"),
            params_dir=os.path.join(work, "params"), bus_uri=uri)
        t_f = time.perf_counter()
        services.create_inference_services(inf2["id"], inf["trial_ids"])
        svc_procs = dict(services.container._procs)
        meta.update_inference_job(inf2["id"], status="RUNNING")
        cache = Cache(BusClient("127.0.0.1", bport))
        replica.wait_line("attached 1 replica worker", PROC_CHILD_S)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 2,
                 PROC_CHILD_S, "the two replicas did not register")
        replica_s = time.perf_counter() - t0
        host = c.get_inference_job(inf["id"])["predictor_host"]
        wids = sorted(cache.running_workers(inf["id"]))
        singles = imgs[:PROC_SINGLES]

        def direct(wid, img):
            bid = cache.send_query_shards([(wid, 0, 1, "s")],
                                          [encode_payload(img)])
            got = cache.gather_prediction_batches(bid, 1, timeout=60)
            check(len(got) == 1, f"worker {wid[:8]} did not answer")
            return np.asarray(got[0]["predictions"][0], np.float64)

        rows_of = {w: np.stack([direct(w, x) for x in singles])
                   for w in wids}
        check(np.array_equal(rows_of[wids[0]], rows_of[wids[1]]),
              "the two replicas' answers differ")
        params = ParamStore(os.path.join(work, "params"))
        own = []
        with uncounted(attn):
            for tid in inf["trial_ids"]:
                trial = meta.get_trial(tid)
                row = meta.get_model(trial["model_id"])
                cls = load_model_class(row["model_class"],
                                       row["model_source"])
                m = cls(device="cuda", **cls.validate_knobs(trial["knobs"]))
                m.load_parameters(params.load(trial["params_id"]))
                own.append(np.asarray(m.predict(list(singles)), np.float64))
                m.destroy()
        params.close()
        err = float(np.abs(rows_of[wids[0]] - np.mean(own, axis=0)).max())
        check(err <= TOL_PROB, f"a replica's answer is {err:.3g} from the "
              f"members' own forward (tolerance {TOL_PROB})")
        via = [ask(host, x, 60) for x in singles]
        check(all(s_ == 200 for s_, _, _ in via),
              f"single queries through the predictor: "
              f"{[s_ for s_, _, _ in via]}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
        print(f"processes: (d) the 2 best trials' bin on the primary and a "
              f"replica child, both registered {replica_s:.2f} s after the "
              f"deploy; {PROC_SINGLES} single queries to each replica over "
              f"the bus bit for bit alike, {err:.3g} from the script's own "
              f"forward of the members (tolerance {TOL_PROB}); device memory "
              f"by process (pid, MiB): {smi} (this script: pid "
              f"{os.getpid()})", flush=True)

        pick = np.random.default_rng(SEED + 7).integers(
            len(imgs), size=PROC_REQUESTS)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(PROC_CLIENTS) as pool:
            window = list(pool.map(lambda i: ask(host, imgs[i], 300),
                                   pick))
        wall = time.perf_counter() - t0
        check(all(s_ == 200 for s_, _, _ in window),
              f"the window's statuses {sorted({s_ for s_, _, _ in window})}")
        lat = sorted(dt for _, dt, _ in window)
        with urllib.request.urlopen(f"http://{host}/metrics",
                                    timeout=30) as r:
            expo = metrics.parse_exposition(r.read().decode())
        took = {}
        for labels, v in expo.get(
                "rafiki_tpu_serving_replica_gather_seconds_count", []):
            took[labels.get("worker")] = took.get(labels.get("worker"),
                                                  0) + v
        check(all(took.get(w[:8], 0) > 0 for w in wids),
              f"shards by replica: {took} (replicas {wids})")
        bus_p50 = {op: (metrics.histogram_percentiles_ms(
            expo.get("rafiki_tpu_bus_op_seconds_bucket", []), qs=(0.5,),
            op=op) or [None])[0] for op in ("push", "pop", "push_many")}
        qps = PROC_REQUESTS / wall
        print(f"processes: (d) {PROC_REQUESTS} single-image requests from "
              f"{PROC_CLIENTS} clients through the predictor over the TCP "
              f"bus: all 200, {qps:.1f} queries/s, p50 "
              f"{percentile(lat, 50) * 1e3:.2f} ms, p99 "
              f"{percentile(lat, 99) * 1e3:.2f} ms; shards by replica "
              f"{ {k: int(v) for k, v in took.items()} }; the primary's "
              f"rafiki_tpu_bus_op_seconds p50 (ms) {bus_p50}; on {card}",
              flush=True)
        out.update(qps=qps, p50_ms=percentile(lat, 50) * 1e3,
                   p99_ms=percentile(lat, 99) * 1e3, bus_p50_ms=bus_p50,
                   replica_s=replica_s, shards=took)

        # (e) the broker killed and restarted, empty, while a client
        # sends.
        stop = threading.Event()
        sent = []

        def keep_asking():
            i = 0
            while not stop.is_set():
                status, _, _ = ask(host, imgs[i % len(imgs)], 15)
                sent.append((time.monotonic(), status))
                i += 1

        sender = threading.Thread(target=keep_asking, daemon=True)
        sender.start()
        time.sleep(0.5)
        t_kill = time.monotonic()
        broker.signal(signal.SIGKILL)
        broker.wait(30)
        broker2 = child("broker2", "broker", "--port", str(bport))
        broker2.wait_line("bus broker (", PROC_CHILD_S)
        t_up = time.monotonic()
        try:
            wait_for(lambda: any(t > t_up and s_ == 200 for t, s_ in sent),
                     PROC_RECOVER_S, "serving did not answer 200 again "
                     f"within {PROC_RECOVER_S} s of the broker's restart")
        finally:
            stop.set()
            sender.join(timeout=30)
        first_ok = min(t for t, s_ in sent if t > t_up and s_ == 200)
        recover_s = first_ok - t_kill
        failed = sum(1 for t, s_ in sent if t_kill < t < first_ok
                     and s_ != 200)
        print(f"processes: (e) the broker child killed and restarted empty "
              f"on port {bport} ({t_up - t_kill:.2f} s to its PORT line) "
              f"while a client sent: 200 again {recover_s:.2f} s after the "
              f"kill; {failed} of {len(sent)} requests failed in between",
              flush=True)
        out.update(recover_s=recover_s, restart_s=t_up - t_kill)

        # (f) the ProcessContainerManager job answers (d)'s queries.
        wait_for(lambda: cache.running_workers(inf2["id"]) and meta.
                 get_inference_job(inf2["id"])["predictor_host"],
                 PROC_CHILD_S, "the service processes did not come up")
        f_s = time.perf_counter() - t_f
        (f_wid,) = cache.running_workers(inf2["id"])
        f_rows = np.stack([direct(f_wid, x) for x in singles])
        check(np.array_equal(f_rows, rows_of[wids[0]]),
              "the service process's answers differ from (d)'s")
        host2 = meta.get_inference_job(inf2["id"])["predictor_host"]
        via2 = [ask(host2, x, 60) for x in singles]
        check([p for _, _, p in via2] == [p for _, _, p in via],
              "answers through the service processes' predictor differ "
              "from the primary's")
        services.stop_inference_services(inf2["id"])
        meta.update_inference_job(inf2["id"], status="STOPPED")
        alive = [pid for pid, p in ((p.pid, p) for p in svc_procs.values())
                 if p.poll() is None]
        check(not alive, f"service processes alive after destroy_service: "
              f"{alive}")
        print(f"processes: (f) an inference job of the same trials through "
              f"a ServicesManager on ProcessContainerManager: "
              f"{len(svc_procs)} `python -m rafiki_torch.container.services`"
              f" children (worker and predictor) up in {f_s:.2f} s; "
              f"{PROC_SINGLES} single queries to its worker and through its "
              f"predictor bit for bit (d)'s; none alive after "
              f"destroy_service", flush=True)
        out.update(services_s=f_s)

        # The nodes leave together; the broker last (a leaving node
        # unregisters over it).
        c.stop_inference_job(inf["id"])
        serve.signal(signal.SIGTERM)
        for ch in (replica, serve):
            check(ch.wait(PROC_CHILD_S) == 0,
                  f"the {ch.name} child failed: {ch.lines[-30:]}")
        broker2.signal(signal.SIGTERM)
        check(broker2.wait(PROC_CHILD_S) == 0,
              f"the broker2 child failed: {broker2.lines[-30:]}")
    except Exception:
        for ch in children:
            print(f"processes: [{ch.name}] last lines: {ch.lines[-30:]}",
                  flush=True)
        raise
    finally:
        if services is not None:
            for svc in meta.get_services(node_id="smoke/processes"):
                services.container.destroy_service(svc["id"])
        for p in svc_procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for ch in children:
            ch.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if meta is not None:
            meta.close()
        left = [ch.name for ch in children if session_alive(ch.proc.pid)]
        left += [p.pid for p in svc_procs.values()
                 if session_alive(p.pid)]
        reps = []
        for f in sorted(glob.glob(os.path.join(reports, "*.json"))):
            with open(f) as fh:
                reps.append(json.load(fh))
        tmp.cleanup()
    check(not left, f"children left running: {left}")
    names = {ch.proc.pid: ch.name for ch in children}
    names.update({p.pid: f"service-{p.pid}" for p in svc_procs.values()})
    rep = {names.get(r["pid"], str(r["pid"])): r for r in reps}
    check(not any(r["jax"] for r in reps), "a child imported jax")
    used = {k: r for k, r in rep.items() if r["kernels"]}
    check(all(set(r["kernels"].values()) == {"loaded"}
              for r in used.values()),
          f"a child built kernels the parent had built: "
          f"{ {k: r['kernels'] for k, r in used.items()} }")
    for who, n in (("join", 3), ("serve", 1), ("replica", 1)):
        r = rep.get(who)
        check(r is not None and all(x > 0 for x in r["launches"][:n])
              and r["wgmma"] == r["launches"],
              f"the {who} child's K1-K3 launches: {r}")
    svc = [r for k, r in rep.items() if k.startswith("service-")
           and r["launches"]]
    check(any(r["launches"][0] > 0 and r["wgmma"] == r["launches"]
              for r in svc), f"the service processes' launches: {svc}")
    launches = tuple(sum(r["launches"][i] for r in reps if r["launches"])
                     for i in range(3))
    phase_s = time.perf_counter() - t_phase
    print(f"processes: children's K1, K2, K3 launches "
          f"{ {k: r['launches'] for k, r in rep.items() if r['launches']} }"
          f", all wgmma, every library loaded, none built; total "
          f"{launches}; their allocators' peak reserve (MiB) "
          f"{ {k: r['max_reserved_mib'] for k, r in rep.items()} }, this "
          f"script's {torch.cuda.max_memory_reserved() / 2**20:.0f} (all "
          f"phases); no child imported jax; none left running; phase "
          f"took {phase_s:.1f} s", flush=True)
    check(phase_s <= PROC_MAX_S, f"the processes phase took {phase_s:.1f} s")
    out.update(launches=launches, phase_s=phase_s)
    return out


CLUSTER_FAMILIES = ("rafiki_tpu_node_", "rafiki_tpu_bus_relay_",
                    "rafiki_tpu_serving_fabric_",
                    "rafiki_tpu_fault_injections_total")


def registry_families(metrics, prefixes):
    """The families in the process registry whose names start with one
    of ``prefixes`` (the cluster fabric's and the fault plane's, or the
    control loop's)."""
    fams = set()
    for line in metrics.registry().expose().splitlines():
        name = line.split("{")[0].split(" ")[0]
        if line and not line.startswith("#") and name.startswith(prefixes):
            fams.add(name)
    return sorted(fams)


def cluster_trials(plat, root, trials, name, n):
    """A STOPPED train job holding the first ``n`` of zoo2 (b)'s ViT
    trials (best first) in ``plat``'s stores: ``(job, trial ids)``."""
    from rafiki_torch.constants import TaskType

    model = plat.admin.create_model(root["id"], name,
                                    TaskType.IMAGE_CLASSIFICATION,
                                    "rafiki_torch.models.vit:TorchViT")
    job = plat.meta.create_train_job(root["id"], name,
                                     TaskType.IMAGE_CLASSIFICATION, {}, "-",
                                     "-", "STOPPED")
    sub = plat.meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    tids = []
    for i, (knobs, p, score) in enumerate(trials[:n]):
        t = plat.meta.create_trial(sub["id"], model["id"], i + 1, "RUNNING",
                                   knobs=knobs)
        plat.meta.mark_trial_completed(t["id"], score,
                                       plat.params.save(p, session_id=name))
        tids.append(t["id"])
    return job, tids


def replicas_in_plan(predictor):
    groups, _, _ = predictor._group_replicas()
    return sum(len(members) for members in groups.values())


def cluster_phase(torch, np, attn, card, zoo2):
    """The fault plane and the cluster serving fabric on the card, with
    zoo2 (b)'s ViT trials (6 blocks) served from ``LocalPlatform``s
    over TCP brokers in this process: (a) no cluster or fault surface
    with the fabric off and no plan; (b) two frontends' edge caches,
    fabric off and on; (c) a promote's fan-out and a gossiped
    invalidation; (d) the relay between two node-scoped brokers, then a
    dead peer; (e) two nodes in the registry; (f) a worker crash, a
    node kill and an injected 503 under load on a bin of two replicas;
    (g) the cost of arming the plane on the memory bus. Returns the
    phase's numbers and K1-K3 launches."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch import faults
    from rafiki_torch.bus import BusClient, BusServer, MemoryBus
    from rafiki_torch.cache import Cache, encode_payload
    from rafiki_torch.client import Client
    from rafiki_torch.constants import ServiceStatus, ServiceType
    from rafiki_torch.observe import metrics
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.predictor.app import PredictorService
    from rafiki_torch.worker.inference import BusInferenceWorker

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    trials = zoo2["lifecycle"]["trials"]
    imgs = zoo2["lifecycle"]["val"][0]
    check(len(trials) >= 2, f"{len(trials)} ViT trials")
    keys = ("RAFIKI_TPU_CLUSTER_FABRIC", "RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S",
            faults.PLAN_ENV, faults.SEED_ENV)
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    faults.reset()
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_")
    brokers, plats, fronts, workers = [], [], [], []
    stop = threading.Event()
    pool = None

    def front(job_id, tag, i):
        f = PredictorService.for_job(
            f"cl-{tag}{i}", job_id, None,
            BusClient(brokers[0].host, brokers[0].port),
            cache_bytes=CLUSTER_CACHE_BYTES, cache_admit_after=1,
            microbatch=False)
        fronts.append(f)
        return f.start()

    def addr(svc):
        return f"{svc.host}:{svc.port}"

    def events(svc):
        return series(metrics, "rafiki_tpu_serving_fabric_total", "event",
                      service=svc.stats.service)

    def injected(site, kind):
        return series(metrics, "rafiki_tpu_fault_injections_total", "kind",
                      site=site).get(kind, 0.0)

    def relay():
        return series(metrics, "rafiki_tpu_bus_relay_total", "direction")

    def relay_delta(base):
        now = relay()
        return {k: now.get(k, 0.0) - base.get(k, 0.0)
                for k in ("out", "in", "fallback")}

    try:
        # (a) The fabric off, no plan: a deployed bin and two frontends.
        before = registry_families(metrics, CLUSTER_FAMILIES)
        check(not faults.enabled() and not before,
              f"cluster or fault series before the phase: {before}")
        broker = BusServer().start()
        brokers.append(broker)
        t0 = time.perf_counter()
        plat = LocalPlatform(workdir=os.path.join(tmp.name, "p"), http=True,
                             supervise_interval=0, bus_uri=broker.uri)
        plats.append(plat)
        root = plat.meta.get_user_by_email("superadmin@rafiki")
        job, tids = cluster_trials(plat, root, trials, "vit-cluster", 2)
        inf = plat.admin.create_inference_job(root["id"], job["id"],
                                              max_models=1)
        cache = Cache(plat.bus)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 1,
                 CLUSTER_WAIT_S, "the ViT worker did not register")
        deploy_s = time.perf_counter() - t0
        (wid0,) = cache.running_workers(inf["id"])
        w0 = plat.container.get(wid0)
        token = Client(admin_port=plat.admin_port).login(
            "superadmin@rafiki", "rafiki")["token"]
        nodes_off = json.loads(admin_get(plat.admin_port, "/nodes", token))
        off = [front(inf["id"], "off", i) for i in range(2)]
        batch = imgs[:CLUSTER_IMAGES]
        n0 = w0.queries_served
        asked_off = [ask(addr(f), x, 120) for f in off for x in batch]
        served_off = w0.queries_served - n0
        check(all(s_ == 200 and a is not None for s_, _, a in asked_off),
              f"(b) fabric off: statuses {[s_ for s_, _, _ in asked_off]}")
        hooks = {"worker": w0._fault, "bus client": plat.bus._fault,
                 "admin http": plat.app._http._fault,
                 "frontend http": off[0]._http._fault,
                 "services": plat.services._node_faults}
        fams = registry_families(metrics, CLUSTER_FAMILIES)
        check(nodes_off == {"enabled": False}
              and plat.node_registry is None
              and not any(f._fabric or f._m_fabric for f in off)
              and all(h is None for h in hooks.values()) and not fams,
              f"(a) surface with the fabric off: /nodes {nodes_off}, "
              f"hooks {hooks}, series {fams}")
        print(f"cluster: (a) the fabric off and no plan: the best ViT "
              f"trial's worker registered {deploy_s:.2f} s after the "
              f"deploy; GET /nodes {nodes_off}; no fault hook at the "
              f"worker, the bus client, the HTTP servers or the node; no "
              f"rafiki_tpu_node_*, _bus_relay_*, _serving_fabric_* or "
              f"_fault_injections_total series", flush=True)
        for f in off:
            f.stop()
        fronts.clear()

        # (b) The fabric on: the same 8 images to each frontend.
        os.environ["RAFIKI_TPU_CLUSTER_FABRIC"] = "1"
        os.environ["RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S"] = \
            str(CLUSTER_PROBE_S)
        fa, fb = [front(inf["id"], "on", i) for i in range(2)]
        check(fa._fabric and fb._fabric, "the frontends are off the fabric")
        n1 = w0.queries_served
        asked_a = [ask(addr(fa), x, 120) for x in batch]
        asked_b = [ask(addr(fb), x, 120) for x in batch]
        served_on = w0.queries_served - n1
        ev_a, ev_b = events(fa), events(fb)
        same = all(b[2] == a[2] for a, b in zip(asked_a, asked_b))
        same_off = all(a[2] == o[2] for a, o in zip(
            asked_a, asked_off[:CLUSTER_IMAGES]))
        check(served_off == 2 * CLUSTER_IMAGES
              and served_on == CLUSTER_IMAGES
              and ev_b == {"peer_hit": float(CLUSTER_IMAGES)}
              and ev_a == {"peer_miss": float(CLUSTER_IMAGES)}
              and all(s_ == 200 for s_, _, _ in asked_a + asked_b)
              and same and same_off,
              f"(b) device queries off {served_off}, on {served_on}; "
              f"events A {ev_a}, B {ev_b}; peer answers equal {same}, the "
              f"fabric-off answers equal {same_off}")
        scatter_ms = 1e3 * sum(dt for _, dt, _ in asked_a) / len(asked_a)
        hit_ms = 1e3 * sum(dt for _, dt, _ in asked_b) / len(asked_b)
        print(f"cluster: (b) two frontends of the job over the TCP bus, "
              f"edge caches admitting on first touch, {CLUSTER_IMAGES} "
              f"unique images to each: {served_off} queries reached the "
              f"device with the fabric off, {served_on} with it on "
              f"(ratio {served_off / served_on:.2f}); frontend B's "
              f"{ev_b.get('peer_hit', 0):.0f} peer hits bit for bit A's "
              f"scatter answers (and the fabric-off ones); a request "
              f"{scatter_ms:.2f} ms on A (probe + scatter), {hit_ms:.2f} "
              f"ms on B (peer hit); on {card}", flush=True)
        out.update(served_off=served_off, served_on=served_on,
                   ratio=served_off / served_on, scatter_ms=scatter_ms,
                   peer_hit_ms=hit_ms)

        # (c) A promote's fan-out, then a direct invalidation's gossip.
        epochs = (fa.edge_cache.epoch, fb.edge_cache.epoch)
        t0 = time.perf_counter()
        plat.admin.promote_trial(inf["id"], tids[1])
        promote_s = time.perf_counter() - t0
        acked = (fa.edge_cache.epoch > epochs[0],
                 fb.edge_cache.epoch > epochs[1])
        n2 = w0.queries_served
        ev_a, ev_b = events(fa), events(fb)
        again = [ask(addr(fa), batch[0], 120), ask(addr(fb), batch[1], 120)]
        rescattered = w0.queries_served - n2
        miss_a = events(fa).get("peer_miss", 0) - ev_a.get("peer_miss", 0)
        miss_b = events(fb).get("peer_miss", 0) - ev_b.get("peer_miss", 0)
        changed = (again[0][2] != asked_a[0][2],
                   again[1][2] != asked_b[1][2])
        check(all(acked) and rescattered == 2 and miss_a == miss_b == 1
              and all(s_ == 200 for s_, _, _ in again) and all(changed),
              f"(c) promote: acknowledged {acked}, rescattered "
              f"{rescattered}, peer misses {miss_a} {miss_b}, answers "
              f"changed {changed}")
        ev_a, ev_b = events(fa), events(fb)
        epoch_b = fb.edge_cache.epoch
        n3 = w0.queries_served
        status, _, _ = post(f"{fa.url}/cache/invalidate", {})
        wait_for(lambda: fb.edge_cache.epoch > epoch_b, 10,
                 "(c) the gossip did not reach frontend B")
        sent_ = events(fa).get("gossip_sent", 0) - ev_a.get("gossip_sent", 0)
        recv_ = events(fb).get("gossip_recv", 0) - ev_b.get("gossip_recv", 0)
        last = ask(addr(fb), batch[1], 120)
        check(status == 200 and sent_ == 1 and recv_ == 1
              and last[0] == 200 and w0.queries_served - n3 == 1
              and last[2] == again[1][2],
              f"(c) gossip: status {status}, sent {sent_}, received "
              f"{recv_}, B's next query {last[0]} with "
              f"{w0.queries_served - n3} device queries")
        print(f"cluster: (c) an additive promote through Admin "
              f"({promote_s:.2f} s, the new bin's worker included) "
              f"acknowledged by both frontends; their next queries missed "
              f"and scattered again ({rescattered} device queries on the "
              f"first bin, the answers now the two bins' vote); a direct "
              f"POST /cache/invalidate on A gossiped to B (gossip_sent "
              f"{sent_:.0f}, gossip_recv {recv_:.0f}), whose next query "
              f"missed and scattered", flush=True)
        out.update(promote_s=promote_s)

        # (d) The relay between two node-scoped brokers.
        r1 = BusServer(node_id="smoke/n1").start()
        brokers.append(r1)
        r2 = BusServer(node_id="smoke/n2").start()
        brokers.append(r2)
        r1.add_peer("smoke/n2", r2.uri)
        r2.add_peer("smoke/n1", r1.uri)
        svc2 = plat.meta.create_service(ServiceType.INFERENCE,
                                        ServiceStatus.DEPLOYING,
                                        node_id="smoke/n2")
        w2 = BusInferenceWorker(svc2["id"], "smoke-relay", tids[0],
                                plat.meta, plat.params,
                                BusClient(r2.host, r2.port), device="cuda",
                                node="smoke/n2")
        workers.append(w2)
        w2.start()
        c1 = Cache(BusClient(r1.host, r1.port))
        c2 = Cache(BusClient(r2.host, r2.port))
        wait_for(lambda: svc2["id"] in c2.running_workers("smoke-relay"),
                 CLUSTER_WAIT_S, "(d) the relay's worker did not register")
        reg = c2.running_worker_info("smoke-relay")[svc2["id"]]
        enc = [encode_payload(x) for x in batch]
        base = relay()
        t0 = time.perf_counter()
        bid = c1.send_query_shards([(svc2["id"], 0, len(enc), 0)], enc,
                                   worker_nodes={svc2["id"]: "smoke/n2"},
                                   local_node="smoke/n1")
        got = c1.gather_prediction_batches(bid, 1, timeout=120)
        relay_s = time.perf_counter() - t0
        deadline = time.monotonic() + 10
        while relay_delta(base) != {"out": 2, "in": 2, "fallback": 0} \
                and time.monotonic() < deadline:
            time.sleep(0.02)  # the reply's 'out' counts once it landed
        hops = relay_delta(base)
        base = relay()
        bid = c2.send_query_shards([(svc2["id"], 0, len(enc), 0)], enc)
        local = c2.gather_prediction_batches(bid, 1, timeout=120)
        check(len(got) == 1 and len(local) == 1 and reg["node"] ==
              "smoke/n2", f"(d) replies {len(got)} relayed, {len(local)} "
              f"local; registration {reg}")
        rows = np.stack([np.asarray(p, np.float64)
                         for p in got[0]["predictions"]])
        rows_l = np.stack([np.asarray(p, np.float64)
                           for p in local[0]["predictions"]])
        check(hops == {"out": 2, "in": 2, "fallback": 0}
              and relay_delta(base) == {"out": 0, "in": 0, "fallback": 0}
              and rows.shape == (CLUSTER_IMAGES, 10)
              and np.isfinite(rows).all()
              and np.array_equal(rows, rows_l),
              f"(d) relay counters {hops}, then {relay_delta(base)}; "
              f"relayed rows {rows.shape} equal the local scatter's "
              f"{np.array_equal(rows, rows_l)}")
        w2.stop()
        r2.stop()
        base = relay()
        t0 = time.perf_counter()
        c1.bus.relay_push("smoke/n2", "smoke-dead", {"v": 1})
        dead_s = time.perf_counter() - t0
        landed = c1.bus.pop("smoke-dead", timeout=2.0)
        check(relay_delta(base) == {"out": 0, "in": 0, "fallback": 1}
              and landed == {"v": 1} and dead_s < 10.0,
              f"(d) dead peer: counters {relay_delta(base)}, landed "
              f"{landed}, {dead_s:.2f} s")
        print(f"cluster: (d) two node-scoped Python brokers, peered, a ViT "
              f"worker (node {reg['node']}) popping from the second: "
              f"{CLUSTER_IMAGES} images scattered from the first node "
              f"through the relay in {relay_s * 1e3:.2f} ms (its bucket's "
              f"runner build included) answered as a local scatter, bit "
              f"for bit; relay out/in/fallback +{hops['out']:.0f}/"
              f"+{hops['in']:.0f}/+{hops['fallback']:.0f} once the hops "
              f"had landed; the second broker stopped, a relay push fell "
              f"back to the first broker (+1) in {dead_s:.3f} s",
              flush=True)
        out.update(relay_ms=relay_s * 1e3, dead_peer_s=dead_s)

        # (e) Two nodes on one workdir, built armed quietly for (f).
        faults.set_plan("")
        wq = os.path.join(tmp.name, "q")
        q1 = LocalPlatform(workdir=wq, http=True, supervise_interval=0,
                           bus_uri=broker.uri)
        plats.append(q1)
        q2 = LocalPlatform(workdir=wq, supervise_interval=0,
                           bus_uri=broker.uri, node_id="smoke/join",
                           stop_jobs_on_shutdown=False, adopt_unowned=False)
        plats.append(q2)
        token_q = Client(admin_port=q1.admin_port).login(
            "superadmin@rafiki", "rafiki")["token"]
        nodes = json.loads(admin_get(q1.admin_port, "/nodes", token_q))
        status_q = json.loads(admin_get(q1.admin_port, "/status", token_q))
        want = sorted([q1.services.node_id, "smoke/join"])
        check(nodes.get("enabled") and sorted(nodes["nodes"]) == want
              and all(r["live"] for r in nodes["nodes"].values())
              and status_q.get("cluster", {}).get("nodes_live") == 2,
              f"(e) GET /nodes {nodes}, /status cluster "
              f"{status_q.get('cluster')}")
        print(f"cluster: (e) two LocalPlatform nodes on one workdir and "
              f"bus: GET /nodes lists {want}, both live (heartbeat ages "
              f"{[r['heartbeat_age_s'] for r in nodes['nodes'].values()]} "
              f"s); /status cluster {status_q['cluster']}", flush=True)

        # (f) A bin of two replicas, one a node, under 8 clients.
        rootq = q1.meta.get_user_by_email("superadmin@rafiki")
        jobq, tidsq = cluster_trials(q1, rootq, trials, "vit-chaos", 1)
        infq = q1.admin.create_inference_job(rootq["id"], jobq["id"],
                                             max_models=1)
        check(q2.services.add_inference_worker(infq["id"], tidsq[0])
              is not None, "(f) the secondary admitted no replica")
        cq = Cache(q1.bus)
        wait_for(lambda: len(cq.running_workers(infq["id"])) == 2,
                 CLUSTER_WAIT_S, "(f) the two replicas did not register")
        hostq = q1.admin.get_inference_job(infq["id"])["predictor_host"]
        prow = next(s_ for s_ in q1.meta.get_services()
                    if s_["service_type"] == ServiceType.PREDICT
                    and s_["status"] == ServiceStatus.RUNNING)
        predq = q1.container.get(prow["id"]).predictor
        predq.gather_timeout = CLUSTER_GATHER_S
        info = cq.running_worker_info(infq["id"])
        check(predq._node == q1.services.node_id and sorted(
            i["node"] for i in info.values()) == want,
            f"(f) the predictor's node {predq._node!r}, the replicas' "
            f"{[i['node'] for i in info.values()]}")
        wait_for(lambda: replicas_in_plan(predq) == 2, CLUSTER_WAIT_S,
                 "(f) the shard plan does not hold both replicas")
        owner = {sid: (q1 if q1.container.get(sid) is not None else q2)
                 for sid in info}
        sent = []

        def load(k):
            rng = np.random.default_rng(CLUSTER_SEED + k)
            while not stop.is_set():
                st, dt, ans = ask(hostq, imgs[int(rng.integers(len(imgs)))],
                                  120)
                sent.append((st, ans is not None, dt, time.monotonic()))

        pool = ThreadPoolExecutor(CLUSTER_CLIENTS)
        futs = [pool.submit(load, k) for k in range(CLUSTER_CLIENTS)]
        time.sleep(CLUSTER_CLEAN_S)
        clean = list(sent)
        crashes = injected("worker", "crash")
        faults.set_plan(CLUSTER_CHAOS_PLAN, seed=CLUSTER_SEED)
        dead = []

        def died():
            dead.extend(s_ for s_, p in owner.items()
                        if not p.container.get(s_).running)
            return bool(dead)

        wait_for(died, CLUSTER_WAIT_S, "(f) the injected crash never fired")
        t_dead = time.monotonic()
        (dead_id,) = dead
        node_of_dead = owner[dead_id]
        row_dead = q1.meta.get_service(dead_id)["status"]
        stale = dead_id in cq.running_workers(infq["id"])
        k1_before = launch_counts(attn)
        restarted = []
        wait_for(lambda: restarted.extend(node_of_dead.services.supervise())
                 or restarted, CLUSTER_WAIT_S, "(f) supervise respawned "
                 "nothing")
        wait_for(lambda: restarted[0] in cq.running_workers(infq["id"])
                 and replicas_in_plan(predq) == 2, CLUSTER_WAIT_S,
                 "(f) the respawned replica is not in the plan")
        recover_s = time.monotonic() - t_dead
        k1_after = launch_counts(attn)
        respawn_k1 = k1_after[0] - k1_before[0]
        respawn_wg = k1_after[3] - k1_before[3]
        crashed = injected("worker", "crash") - crashes
        delays = injected("bus", "delay")
        check(row_dead == ServiceStatus.RUNNING and stale
              and crashed == 1 and len(restarted) == 1
              and respawn_k1 > 0 and respawn_wg == respawn_k1,
              f"(f) crash: row {row_dead}, registration stale {stale}, "
              f"counted {crashed}, restarted {restarted}, K1 in the "
              f"respawn {respawn_k1} ({respawn_wg} wgmma)")
        owner[restarted[0]] = node_of_dead
        # The batches the crash caught settle (a gather timeout) before
        # the next injury: a resubmit racing a second death is a second
        # fault, which the planner does not claim to survive.
        time.sleep(CLUSTER_GATHER_S)
        # The secondary node dies; the primary's replica answers.
        kills = injected("node", "kill")
        faults.set_plan("node.kill:op=smoke/join,n=1")
        spared = q1.services.supervise()
        q2.services.supervise()
        t_kill = time.monotonic()
        killed = injected("node", "kill") - kills
        victim = [s_ for s_ in cq.running_workers(infq["id"])
                  if owner.get(s_) is q2]
        mid = [ask(hostq, x, 120) for x in batch[:4]]
        respawned = []
        wait_for(lambda: respawned.extend(q2.services.supervise())
                 or respawned, CLUSTER_WAIT_S, "(f) the secondary's sweep "
                 "respawned nothing")
        wait_for(lambda: respawned[0] in cq.running_workers(infq["id"])
                 and replicas_in_plan(predq) == 2, CLUSTER_WAIT_S,
                 "(f) the secondary's new replica is not in the plan")
        kill_s = time.monotonic() - t_kill
        stop.set()
        for f in futs:
            f.result(timeout=300)
        pool.shutdown()
        pool = None
        ok = sum(1 for st, a, _, _ in sent if st == 200 and a)
        lost = [(st, a, round(dt, 3), round(t - t_dead, 3),
                 round(t - t_kill, 3)) for st, a, dt, t in sent
                if not (st == 200 and a)]
        resubmits = predq._m_resubmits.value(service=predq.service)
        quarantines = predq._m_quarantines.value(service=predq.service)
        check(spared == [] and killed == 1 and len(victim) == 1
              and q2.container.get(victim[0]) is None
              and all(st == 200 and a is not None for st, _, a in mid)
              and len(respawned) == 1 and ok == len(sent) and clean,
              f"(f) node.kill: the primary's sweep {spared}, counted "
              f"{killed}, victim {victim}, answers meanwhile "
              f"{[st for st, _, _ in mid]}, respawned {respawned}; "
              f"{ok} of {len(sent)} queries answered; not answered "
              f"(status, answer, seconds, since the crash, since the "
              f"kill): {lost}; resubmits {resubmits}, quarantines "
              f"{quarantines}")
        faults.set_plan("http.error:route=/predict,n=1")
        statuses = [ask(hostq, x, 120)[0] for x in batch[:4]]
        check(statuses == [503, 200, 200, 200],
              f"(f) http.error: statuses {statuses}")
        faults.set_plan(None)
        lat = sorted(dt for _, _, dt, _ in sent)
        print(f"cluster: (f) a bin of two replicas, one on each node, "
              f"built armed quietly: {len(clean)} queries in a clean "
              f"{CLUSTER_CLEAN_S:.0f} s window from {CLUSTER_CLIENTS} "
              f"clients, then {CLUSTER_CHAOS_PLAN!r} (seed {CLUSTER_SEED})"
              f": the crash counted {crashed:.0f} (on the "
              f"{'primary' if node_of_dead is q1 else 'secondary'}), "
              f"{delays:.0f} bus delays; the row left RUNNING and the "
              f"registration stale until supervise respawned the replica "
              f"(K1 launched {respawn_k1} times meanwhile, all wgmma: its "
              f"runner builds and new buckets' captures): "
              f"{recover_s:.2f} s from the death to the full plan; "
              f"node.kill of smoke/join: the bin answered "
              f"{len(mid)} of {len(mid)} queries from the primary's "
              f"replica, and the secondary's next sweep had its replica "
              f"back in the plan {kill_s:.2f} s after the kill; "
              f"availability {ok}/{len(sent)} = {ok / len(sent):.4f} "
              f"({resubmits:.0f} shards resubmitted, {quarantines:.0f} "
              f"quarantines), p50 {percentile(lat, 50) * 1e3:.2f} ms, p99 "
              f"{percentile(lat, 99) * 1e3:.2f} ms; http.error:route="
              f"/predict,n=1 gave {statuses}", flush=True)
        out.update(recover_s=recover_s, kill_s=kill_s, queries=len(sent),
                   availability=ok / len(sent), respawn_k1=respawn_k1)

        # (e) continued: a node's shutdown withdraws its record.
        q2.shutdown()
        plats.remove(q2)
        after = json.loads(admin_get(q1.admin_port, "/nodes", token_q))
        check(sorted(after["nodes"]) == [q1.services.node_id],
              f"(e) after the secondary's shutdown: {after['nodes']}")
        print(f"cluster: (e) the secondary's shutdown withdrew its record: "
              f"GET /nodes lists {sorted(after['nodes'])}", flush=True)

        # (g) The cost of arming: memory-bus push+pop pairs a second.
        rates = {"disarmed": [], "armed": []}
        for mode in ("disarmed", "armed", "armed", "disarmed"):
            faults.set_plan("" if mode == "armed" else None)
            bus = MemoryBus()
            check((bus._fault is not None) == (mode == "armed"),
                  f"(g) a {mode} bus's hook {bus._fault}")
            t0 = time.perf_counter()
            for i in range(CLUSTER_BUS_OPS):
                bus.push("q", i)
                bus.pop("q")
            rates[mode].append(2 * CLUSTER_BUS_OPS
                               / (time.perf_counter() - t0))
        faults.set_plan(None)
        off_r = sum(rates["disarmed"]) / 2
        on_r = sum(rates["armed"]) / 2
        print(f"cluster: (g) memory-bus operations a second, push and pop "
              f"of {CLUSTER_BUS_OPS} items each way, in turns: disarmed "
              f"{[round(r) for r in rates['disarmed']]}, armed with no "
              f"rules {[round(r) for r in rates['armed']]}; armed / "
              f"disarmed {on_r / off_r:.3f}", flush=True)
        out.update(bus_ops_disarmed=off_r, bus_ops_armed=on_r)
    finally:
        stop.set()
        if pool is not None:
            pool.shutdown(wait=True)
        faults.set_plan(None)
        for f in fronts:
            f.stop()
        for w in workers:
            w.stop()
        for p in reversed(plats):
            p.shutdown()
        for b in brokers:
            b.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
        tmp.cleanup()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(launches[0] > 0 and launches[3] == launches[0],
          f"the cluster phase launched K1 {launches[0]} times, "
          f"{launches[3]} on wgmma")
    check(phase_s <= CLUSTER_MAX_S, f"the cluster phase took {phase_s:.1f} s")
    print(f"cluster: K1, K2 and K3 launched {launches[:3]} times in the "
          f"phase (runner builds of six workers and captures at new "
          f"buckets; replays run uncounted), all K1 on wgmma; phase took "
          f"{phase_s:.1f} s on {card}", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


AUTOSCALE_FAMILIES = ("rafiki_tpu_autoscale_", "rafiki_tpu_slo_")


def decisions(scaler, action, reason=None):
    """The autoscaler's applied decisions of one kind, oldest first."""
    return [d for d in reversed(scaler.snapshot()["decisions"])
            if d["action"] == action and d.get("applied")
            and (reason is None or d["reason"] == reason)]


def autoscale_phase(torch, np, attn, card, zoo2):
    """The serving control loop on the card, with zoo2 (b)'s best ViT
    trial (6 blocks) served from ``LocalPlatform``s built through
    ``NodeConfig``: (a) no control-loop surface with the loop off, and
    the clean p99 that sets the objective; (b) an SLO alert under
    ``worker.slow`` driving a scale-up; (c) the alert resolving and a
    drain back to one replica under load; (d) 429s driving a scale-up;
    (e) the recorded workload replayed against the live device-time
    histogram; (f) the capacity CLI's exit codes. Returns the phase's
    numbers and K1-K3 launches."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch import faults
    from rafiki_torch.admin import capacity
    from rafiki_torch.cache import Cache, encode_payload
    from rafiki_torch.client import Client
    from rafiki_torch.config import NodeConfig
    from rafiki_torch.constants import ServiceStatus
    from rafiki_torch.observe import attribution, metrics, replay, workload
    from rafiki_torch.observe import slo as slo_mod
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.predictor.app import PredictorService

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    trials = zoo2["lifecycle"]["trials"]
    imgs = zoo2["lifecycle"]["val"][0]
    check(len(trials) >= 1, f"{len(trials)} ViT trials")
    saved_env = dict(os.environ)
    faults.reset()
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_autoscale_")
    plats = []
    stop = threading.Event()
    pool = None
    sent = []

    def node(name, **fields):
        """A platform from a validated NodeConfig, as ``serve`` builds
        one; its switches exported first."""
        cfg = NodeConfig(workdir=os.path.join(tmp.name, name), port=0,
                         supervise_interval=AUTOSCALE_SWEEP_S,
                         serving_attribution=True, workload_record=True,
                         serving_queue_cap=AUTOSCALE_QUEUE_CAP,
                         **fields).validate()
        cfg.apply_env()
        # The ledger and the recorder read their switches once a process.
        attribution.reset_for_tests()
        workload.reset_for_tests()
        plat = LocalPlatform.from_config(cfg, http=True)
        plats.append(plat)
        return plat

    def deploy(plat, name):
        root = plat.meta.get_user_by_email("superadmin@rafiki")
        job, _ = cluster_trials(plat, root, trials, name, 1)
        inf = plat.admin.create_inference_job(root["id"], job["id"],
                                              max_models=1)
        cache = Cache(plat.bus)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 1,
                 AUTOSCALE_WAIT_S, f"{name}: the ViT worker did not "
                 f"register")
        token = Client(admin_port=plat.admin_port).login(
            "superadmin@rafiki", "rafiki")["token"]
        return (inf, cache, token,
                plat.admin.get_inference_job(inf["id"])["predictor_host"])

    def ask_many(host, batch):
        """One ``POST /predict`` of several images: (status, seconds,
        whether every image was answered)."""
        req = urllib.request.Request(
            f"http://{host}/predict", data=json.dumps(
                {"queries": [encode_payload(x) for x in batch]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                preds = json.loads(r.read())["predictions"]
                return (r.status, time.perf_counter() - t0,
                        len(preds) == len(batch)
                        and all(p is not None for p in preds))
        except urllib.error.HTTPError as e:
            e.read()
            return e.code, time.perf_counter() - t0, False

    def load(host, n, tag, per_request=1):
        """``n`` closed-loop clients until ``stop``, each request
        ``per_request`` images; a 429 backs off 10 ms."""
        def client(k):
            rng = np.random.default_rng(AUTOSCALE_SEED + k)
            while not stop.is_set():
                pick = rng.integers(len(imgs), size=per_request)
                if per_request == 1:
                    st, dt, ans = ask(host, imgs[int(pick[0])], 120)
                    ans = ans is not None
                else:
                    st, dt, ans = ask_many(host, imgs[pick])
                sent.append((tag, st, ans, dt, time.monotonic()))
                if st == 429:
                    time.sleep(0.01)

        ex = ThreadPoolExecutor(n)
        return ex, [ex.submit(client, k) for k in range(n)]

    def halt(ex, futs):
        stop.set()
        for f in futs:
            f.result(timeout=300)
        ex.shutdown()
        stop.clear()

    def route(plat, token, path):
        return json.loads(admin_get(plat.admin_port, path, token))

    try:
        # (a) The loop off: a deployed bin, its frontend and a clean
        # window that sets the objective's threshold.
        plat0 = node("off")
        inf0, _, token0, host0 = deploy(plat0, "vit-as-off")
        pool, futs = load(host0, AUTOSCALE_CLIENTS, "warm")
        time.sleep(AUTOSCALE_WARM_S)
        t_clean = time.monotonic()
        time.sleep(AUTOSCALE_CLEAN_S)
        halt(pool, futs)
        pool = None
        clean = [x for x in sent if x[4] - x[3] >= t_clean]
        check(clean and all(st == 200 and a for _, st, a, _, _ in clean),
              f"(a) clean window: {len(clean)} queries, statuses "
              f"{sorted({st for _, st, _, _, _ in clean})}")
        clean_p99 = percentile(sorted(dt for *_, dt, _ in clean), 99)
        want = max(AUTOSCALE_THRESHOLD_X * clean_p99 * 1e3,
                   AUTOSCALE_MIN_THRESHOLD_MS)
        threshold_ms = min(b * 1e3 for b in metrics.LATENCY_BUCKETS
                           if b * 1e3 >= want)
        slow_ms = int(AUTOSCALE_SLOW_X * threshold_ms)
        rule = AUTOSCALE_RULE.format(ms=threshold_ms)
        off_routes = {p: route(plat0, token0, p)
                      for p in ("/autoscale", "/slo", "/alerts")}
        cap0 = route(plat0, token0, "/capacity")
        fams = registry_families(metrics, AUTOSCALE_FAMILIES)
        check(plat0.services.autoscaler is None
              and plat0.services.slo_engine is None and not fams
              and off_routes == {p: {"enabled": False} for p in off_routes}
              and cap0["enabled"] and cap0["gate"]["ok"]
              and cap0["policy_source"] == "defaults",
              f"(a) the loop off: routes {off_routes}, /capacity gate "
              f"{cap0.get('gate', {}).get('ok')}, series {fams}")
        print(f"autoscale: (a) the loop off: a bin of the best ViT trial "
              f"and its frontend; no rafiki_tpu_autoscale_* or "
              f"rafiki_tpu_slo_* series; GET /autoscale, /slo and /alerts "
              f"{{\"enabled\": false}}; GET /capacity's canned-ramp gate "
              f"green under the default policy (simulated p99 "
              f"{cap0['gate']['latency_ms']['p99']} ms); {len(clean)} "
              f"queries from {AUTOSCALE_CLIENTS} clients in a clean "
              f"{AUTOSCALE_CLEAN_S:.0f} s window, p99 "
              f"{clean_p99 * 1e3:.2f} ms: the objective {rule!r}, "
              f"worker.slow at {slow_ms} ms", flush=True)
        out.update(clean_p99_ms=clean_p99 * 1e3, threshold_ms=threshold_ms)
        plat0.shutdown()
        plats.remove(plat0)

        # (b) The loop armed; an SLO alert drives a scale-up.
        plat = node("on", autoscale=True, slo_rules=rule,
                    **AUTOSCALE_KNOBS)
        scaler, engine = plat.services.autoscaler, plat.services.slo_engine
        check(scaler is not None and engine is not None,
              f"the loop is not armed: {scaler} {engine}")
        faults.set_plan("")  # armed quietly before the workers are built
        inf, cache, token, host = deploy(plat, "vit-as")
        (wid0,) = cache.running_workers(inf["id"])
        # The worker's first buckets are captured through a frontend of
        # the phase's own, whose latency histogram the objective does not
        # read: a capture's stall is not the bin's steady latency.
        warm = PredictorService.for_job("as-warm", inf["id"], None,
                                        plat.bus).start()
        pool, futs = load(f"{warm.host}:{warm.port}", AUTOSCALE_CLIENTS,
                          "warm")
        time.sleep(AUTOSCALE_WARM_S)
        halt(pool, futs)
        warm.stop()
        wall_warm = time.time()
        sent.clear()
        pool, futs = load(host, AUTOSCALE_CLIENTS, "b")
        time.sleep(AUTOSCALE_CLEAN_S)

        def settled():
            return all(i["state"] == "ok"
                       for o in engine.snapshot()["objectives"]
                       for i in o["instances"])

        wait_for(settled, AUTOSCALE_WAIT_S,
                 "(b) the clean bin's alert did not settle")
        blips = len(engine.alerts_snapshot()["alerts"])
        check(decisions(scaler, "scale_up") == [],
              f"(b) before the fault: alerts "
              f"{engine.alerts_snapshot()['alerts']}, decisions "
              f"{scaler.snapshot()['decisions']}")
        epoch_arm = engine.epoch
        k1_armed = launch_counts(attn)
        faults.set_plan(f"worker.slow:ms={slow_ms}")
        t_arm = time.monotonic()
        name = rule.split(":")[0]
        wait_for(lambda: name in engine.alerts_snapshot()["firing"],
                 AUTOSCALE_WAIT_S, "(b) the alert never fired")
        t_fire = time.monotonic()
        wait_for(lambda: decisions(scaler, "scale_up", "slo_firing"),
                 AUTOSCALE_WAIT_S, "(b) no slo_firing scale-up")
        up = decisions(scaler, "scale_up", "slo_firing")[0]
        wid1 = next(w["service_id"] for w in
                    plat.services.active_inference_workers(inf["id"])
                    if w["service_id"] != wid0)

        def first_shard():
            w = plat.container.get(wid1)
            return w is not None and w.queries_served > 0

        wait_for(lambda: wid1 in cache.running_workers(inf["id"])
                 and first_shard(), AUTOSCALE_WAIT_S,
                 "(b) the new replica took no shard")
        t_shard = time.monotonic()
        k1_up = launch_counts(attn)
        up_k1 = k1_up[0] - k1_armed[0]
        up_wg = k1_up[3] - k1_armed[3]
        check(up["service_id"] == wid1[:8] and up_k1 > 0
              and up_wg == up_k1,
              f"(b) scale-up {up}, new replica {wid1[:8]}, K1 launched "
              f"{up_k1} times ({up_wg} wgmma)")
        print(f"autoscale: (b) the loop armed on a bin of one replica "
              f"(supervise every {AUTOSCALE_SWEEP_S} s, {AUTOSCALE_KNOBS}); "
              f"under {AUTOSCALE_CLIENTS} clients, worker.slow:ms={slow_ms} "
              f"armed ({blips} alert transitions in the clean window "
              f"before it): the alert fired {t_fire - t_arm:.2f} s after the "
              f"arming; scale_up for slo_firing (signals "
              f"{up['signals']}); the new "
              f"replica {wid1[:8]}'s first shard {t_shard - t_fire:.2f} s "
              f"after the firing (K1 launched {up_k1} times meanwhile, all "
              f"wgmma: its runner builds)", flush=True)
        out.update(arm_to_fire_s=t_fire - t_arm,
                   fire_to_shard_s=t_shard - t_fire, up_k1=up_k1)

        # (c) The plan disarmed: the alert resolves, then a drain.
        faults.set_plan("")
        t_disarm = time.monotonic()
        wait_for(lambda: name not in engine.alerts_snapshot()["firing"],
                 AUTOSCALE_WAIT_S, "(c) the alert never resolved")
        t_resolved = time.monotonic()
        wait_for(lambda: decisions(scaler, "scale_down"), AUTOSCALE_WAIT_S,
                 "(c) no scale-down")
        down = decisions(scaler, "scale_down")[0]
        wait_for(lambda: len(plat.services.active_inference_workers(
            inf["id"])) == 1 and wid1 not in cache.running_workers(
            inf["id"]), AUTOSCALE_WAIT_S, "(c) the bin kept two replicas")
        # The drain runs inside the sweep: from the decision's start (its
        # wall-clock stamp) to the bin seen with one replica.
        drain_s = time.time() - down["t"]
        time.sleep(1.0)  # clients keep sending to the single replica
        halt(pool, futs)
        pool = None
        owners = [len(o) for o in plat.allocator._owners]
        row1 = plat.meta.get_service(wid1)["status"]
        served = [x for x in sent if x[0] == "b"]
        ok = sum(1 for _, st, a, _, _ in served if st == 200 and a)
        alerts = route(plat, token, "/alerts")
        trans = [a["transition"] for a in reversed(alerts["alerts"])
                 if a["objective"] == name and a["epoch"] > epoch_arm]
        slo_now = route(plat, token, "/slo")
        [inst] = slo_now["objectives"][0]["instances"]
        check(down["service_id"] == wid1[:8] and down["drained"]
              and row1 == ServiceStatus.STOPPED and owners == [1]
              and ok == len(served) and trans == ["pending", "firing",
                                                  "resolved"]
              and inst["state"] == "ok" and inst["budget_remaining"] < 1.0,
              f"(c) scale-down {down}, the replica's row {row1}, chip "
              f"owners {owners}; {ok} of {len(served)} queries answered; "
              f"transitions {trans}; /slo {inst}")
        lat = sorted(dt for *_, dt, _ in served)
        resolved = next(a for a in alerts["alerts"]
                        if a["objective"] == name
                        and a["transition"] == "resolved")
        print(f"autoscale: (c) the plan disarmed: the alert resolved "
              f"{t_resolved - t_disarm:.2f} s later; scale_down drained "
              f"{wid1[:8]} {down['t'] - resolved['t']:.2f} s after that (down "
              f"cooldown {AUTOSCALE_KNOBS['autoscale_down_cooldown_s']} s "
              f"from the scale-up), the drain taking {drain_s:.2f} s from "
              f"the decision to one replica, its chip share released "
              f"(owners {owners}); {ok}/{len(served)} queries answered "
              f"through (b) and (c), p50 {percentile(lat, 50) * 1e3:.2f} "
              f"ms, p99 {percentile(lat, 99) * 1e3:.2f} ms; GET /alerts "
              f"{trans}; GET /slo budget remaining "
              f"{inst['budget_remaining']} of the {inst['total']:.0f} "
              f"requests in the window", flush=True)
        out.update(resolve_s=t_resolved - t_disarm,
                   drain_s=drain_s, answered=ok,
                   queries=len(served))

        # (d) Backpressure drives a scale-up.
        pool, futs = load(host, AUTOSCALE_BURST_CLIENTS, "d",
                          AUTOSCALE_BURST_IMAGES)
        t_burst = time.monotonic()
        wait_for(lambda: decisions(scaler, "scale_up", "backpressure"),
                 AUTOSCALE_WAIT_S, "(d) no backpressure scale-up")
        t_bp = time.monotonic()
        halt(pool, futs)
        pool = None
        bp = decisions(scaler, "scale_up", "backpressure")[0]
        burst = [x for x in sent if x[0] == "d"]
        n429 = sum(1 for _, st, _, _, _ in burst if st == 429)
        wait_for(lambda: len(cache.running_workers(inf["id"])) == 2,
                 AUTOSCALE_WAIT_S, "(d) the new replica did not register")
        check(n429 > 0 and bp["signals"]["backpressure_delta"] > 0
              and all(st == 429 or (st == 200 and a)
                      for _, st, a, _, _ in burst),
              f"(d) {n429} 429s of {len(burst)}; {bp}")
        print(f"autoscale: (d) {AUTOSCALE_BURST_CLIENTS} clients of "
              f"{AUTOSCALE_BURST_IMAGES} images a request against an "
              f"admission queue of {AUTOSCALE_QUEUE_CAP} queries: "
              f"{n429} of {len(burst)} requests answered 429; scale_up "
              f"for backpressure {t_bp - t_burst:.2f} s after the burst "
              f"began (signals {bp['signals']})", flush=True)

        # (e) The recorded workload replayed against the live histogram.
        job_label = f'job="{inf["id"][:12]}"'
        live = [line for line in urllib.request.urlopen(
            f"http://{host}/metrics", timeout=30).read().decode()
            .splitlines() if line.startswith(
                f"{replay.FLEET_SOURCE_SERIES}_bucket")
            and job_label in line]
        fleet = replay.FleetModel.from_exposition("\n".join(live) + "\n")
        check(fleet is not None, "(e) no live device-time histogram")
        trace = [r for r in capacity.resolve_trace(plat.services.log_dir)
                 if r.get("job") == inf["id"][:12]
                 and float(r.get("t") or 0.0) >= wall_warm]
        sim = replay.SimKnobs(seed=AUTOSCALE_SEED,
                              sweep_interval_s=AUTOSCALE_SWEEP_S,
                              queue_cap=float(AUTOSCALE_QUEUE_CAP),
                              max_batch=AUTOSCALE_QUEUE_CAP,
                              provision_delay_s=t_shard - t_fire)
        report = replay.simulate(trace, fleet=fleet, sim=sim,
                                 policy=scaler.policy.knobs,
                                 objectives=slo_mod.parse_rules(rule))
        live_ms = sorted(float(r["dur_ms"]) for r in trace
                         if r.get("status") == 200)
        live_actions = {}
        for d in scaler.snapshot()["decisions"]:
            if d.get("applied"):
                k = f"{d['action']}:{d['reason']}"
                live_actions[k] = live_actions.get(k, 0) + 1
        check(report["served"] > 0 and live_ms, f"(e) replay {report}")
        print(f"autoscale: (e) the phase's {len(trace)} recorded requests "
              f"replayed over the bin's live device-time histogram "
              f"({len(fleet.bins)} bin) under the live knobs: simulated "
              f"p50 {report['latency_ms']['p50']} ms, p99 "
              f"{report['latency_ms']['p99']} ms, {report['rejected']} "
              f"rejected, actions {report['actions']}, SLO "
              f"{report['slo'][name]['state']} (fired "
              f"{report['slo'][name]['firing_s']} s); live p50 "
              f"{percentile(live_ms, 50):.2f} ms, p99 "
              f"{percentile(live_ms, 99):.2f} ms, "
              f"{len(trace) - len(live_ms)} rejected, actions "
              f"{live_actions}", flush=True)
        out.update(sim_p99_ms=report["latency_ms"]["p99"],
                   live_p99_ms=percentile(live_ms, 99),
                   sim_actions=report["actions"], live_actions=live_actions)

        # (f) The capacity CLI's exit codes.
        root_dir = os.path.dirname(os.path.abspath(__file__))
        rcs = []
        for extra in ([], ["--policy", AUTOSCALE_DEGRADED]):
            done = subprocess.run(
                [sys.executable, "-m", "rafiki_torch.capacity", "score",
                 "--trace", "ramp"] + extra, cwd=root_dir,
                capture_output=True, text=True, timeout=120)
            rcs.append((done.returncode,
                        json.loads(done.stdout)["violations"]
                        if done.stdout.strip() else done.stderr[-300:]))
        check([rc for rc, _ in rcs] == [0, 1],
              f"(f) the CLI's exit codes {rcs}")
        print(f"autoscale: (f) python -m rafiki_torch.capacity score "
              f"--trace ramp: exit {rcs[0][0]}; with --policy "
              f"{AUTOSCALE_DEGRADED}: exit {rcs[1][0]}, violations "
              f"{rcs[1][1]}", flush=True)
    finally:
        stop.set()
        if pool is not None:
            pool.shutdown(wait=True)
        faults.set_plan(None)
        for p in reversed(plats):
            p.shutdown()
        os.environ.clear()
        os.environ.update(saved_env)
        faults.reset()
        attribution.reset_for_tests()
        workload.reset_for_tests()
        tmp.cleanup()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(launches[0] > 0 and launches[3] == launches[0],
          f"the autoscale phase launched K1 {launches[0]} times, "
          f"{launches[3]} on wgmma")
    check(phase_s <= AUTOSCALE_MAX_S,
          f"the autoscale phase took {phase_s:.1f} s")
    print(f"autoscale: K1, K2 and K3 launched {launches[:3]} times in the "
          f"phase (runner builds of four workers and captures at new "
          f"buckets; replays run uncounted), all K1 on wgmma; phase took "
          f"{phase_s:.1f} s on {card}", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


DASHBOARD_FETCH = re.compile(r'api\("(GET|POST)",\s*["`]([^"`]*)["`]'
                             r'|fetch\(`([^`?]*)[^`]*`,\s*\{method:\s*"(\w+)"')


def dashboard_fetches(html):
    """(method, path) of every request the dashboard page makes, each
    ``${...}`` as ``<x>``, without the query string."""
    out = set()
    for m in DASHBOARD_FETCH.finditer(html):
        method, path = (m.group(1), m.group(2)) if m.group(1) \
            else (m.group(4), m.group(3))
        out.add((method, re.sub(r"\$\{[^}]*\}", "<x>", path.split("?")[0])))
    return sorted(out)


def admin_status(port, method, path, token):
    """The status of one admin request with the bearer token and no
    body."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        headers={"Authorization": f"Bearer {token}"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def forged_upload(port):
    """The first line of the answer to a ``POST /datasets`` that claims
    a body of 1 TiB and sends none."""
    import socket

    conn = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        conn.sendall(("POST /datasets?name=x&task=T HTTP/1.1\r\n"
                      "Host: 127.0.0.1\r\n"
                      "Content-Type: application/octet-stream\r\n"
                      f"Content-Length: {1 << 40}\r\n\r\n").encode())
        return conn.recv(4096).decode().splitlines()[0]
    finally:
        conn.close()


def operator_phase(torch, np, attn, card, zoo2):
    """The operator and data surface on the card, over HTTP to one
    ``LocalPlatform``: (a) zoo2's images uploaded as datasets; (b) a
    ViT job trained from the uploaded files (K1-K3 on wgmma, the trials'
    plot and loss records); (c) the train and inference workers' logs;
    (d) the best trial served with the packed wire off and then on, the
    same answers bit for bit, and one query through ``Cache.send_query``;
    (e) the dashboard and every route it fetches; (f) the chips'
    utilization. Returns the phase's numbers and K1-K3 launches."""
    import os

    from rafiki_torch.cache import Cache
    from rafiki_torch.client import Client, ClientError
    from rafiki_torch.constants import TaskType, UserType
    from rafiki_torch.observe import metrics, wire
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.web import dashboard_html

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    timgs, tlabels = zoo2["operator"]["train"]
    vimgs, vlabels = zoo2["lifecycle"]["val"]
    n_classes = zoo2["operator"]["n_classes"]
    saved_env = dict(os.environ)
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_operator_")
    plat = None
    try:
        plat = LocalPlatform(workdir=os.path.join(tmp.name, "node"),
                             http=True, supervise_interval=1.0)
        port = plat.admin_port
        client = Client(admin_port=port)
        token = client.login("superadmin@rafiki", "rafiki")["token"]

        # (a) The sets uploaded; listed; a duplicate and a forged size
        # refused.
        t0 = time.perf_counter()
        files = {}
        for name, x, y in (("train", timgs, tlabels),
                           ("val", vimgs, vlabels)):
            files[name] = os.path.join(tmp.name, f"{name}.npz")
            np.savez(files[name], images=x, labels=y, n_classes=n_classes)
        up = {n: client.create_dataset(f"cifar-{n}",
                                       TaskType.IMAGE_CLASSIFICATION, f)
              for n, f in files.items()}
        up_s = time.perf_counter() - t0
        listed = client.get_datasets(task=TaskType.IMAGE_CLASSIFICATION)
        none_listed = client.get_datasets(task=TaskType.POS_TAGGING)
        try:
            client.create_dataset("cifar-val", TaskType.IMAGE_CLASSIFICATION,
                                  files["val"])
            dup = None
        except ClientError as e:
            dup = e.status
        forged = forged_upload(port)
        check(sorted(d["name"] for d in listed) == ["cifar-train",
                                                    "cifar-val"]
              and none_listed == [] and dup == 400 and " 413 " in forged
              and all(os.path.getsize(up[n]["path"])
                      == os.path.getsize(files[n])
                      == up[n]["size_bytes"] for n in files)
              and all(os.path.dirname(up[n]["path"])
                      == os.path.join(plat.workdir, "datasets")
                      for n in files),
              f"(a) uploads {up}, listed {listed}, duplicate {dup}, forged "
              f"{forged!r}")
        print(f"operator: (a) {len(timgs)} train and {len(vimgs)} val "
              f"images uploaded as .npz over POST /datasets "
              f"({sum(u['size_bytes'] for u in up.values())} bytes) in "
              f"{up_s:.2f} s, stored in the node's datasets dir; GET "
              f"/datasets?task=IMAGE_CLASSIFICATION lists both, "
              f"?task=POS_TAGGING none; a duplicate name answered "
              f"{dup}; a forged 1 TiB Content-Length answered "
              f"{forged.split(' ', 1)[1]!r} before any body", flush=True)

        # (b) A ViT job trained from the uploaded files.
        model = client.create_model("vit-op", TaskType.IMAGE_CLASSIFICATION,
                                    "OperatorViT",
                                    model_source=OPERATOR_VIT_SOURCE)
        t0 = time.perf_counter()
        job = client.create_train_job(
            "operator", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {"MODEL_TRIAL_COUNT": OPERATOR_TRIALS}, up["train"]["path"],
            up["val"]["path"])
        util_max = 0.0
        deadline = time.monotonic() + OPERATOR_WAIT_S
        while True:
            util_max = max(util_max, plat.services.chip_utilization())
            row = client.get_train_job(job["id"])
            if row["status"] in ("STOPPED", "ERRORED"):
                break
            check(time.monotonic() < deadline,
                  f"(b) the train job still {row['status']}")
            time.sleep(0.1)
        train_s = time.perf_counter() - t0
        trials = client.get_trials_of_train_job(job["id"])
        launches_b = launch_counts(attn)
        logs = {t["id"]: [r["record"] for r in
                          client.get_trial_logs(t["id"])]
                for t in trials}
        plots = {tid: [r["plot"] for r in recs if r.get("type") == "plot"]
                 for tid, recs in logs.items()}
        losses = {tid: [r["values"]["loss"] for r in recs
                        if r.get("type") == "values"
                        and "loss" in r.get("values", {})]
                  for tid, recs in logs.items()}
        check(row["status"] == "STOPPED" and len(trials) == OPERATOR_TRIALS
              and all(t["status"] == "COMPLETED"
                      and 0.0 <= t["score"] <= 1.0 for t in trials)
              and all(any(p["title"] == "Training" and "loss" in
                          p["metrics"] and p["x_axis"] == "epoch"
                          for p in plots[t["id"]]) for t in trials)
              and all(len(losses[t["id"]]) == OPERATOR_EPOCHS
                      and all(math.isfinite(v) for v in losses[t["id"]])
                      for t in trials),
              f"(b) job {row['status']}, trials "
              f"{[(t['status'], t.get('score')) for t in trials]}, "
              f"plots {plots}, losses {losses}")
        check(all(launches_b[i] > 0 and launches_b[3 + i] == launches_b[i]
                  for i in range(3)),
              f"(b) K1-K3 launches {launches_b}")
        print(f"operator: (b) a train job of {OPERATOR_TRIALS} ViT trials "
              f"(6 blocks, d_model 128, batch 256, {OPERATOR_EPOCHS} epochs "
              f"of {len(timgs) // 256} steps) named the uploaded paths and "
              f"trained from the stored files in {train_s:.2f} s: scores "
              f"{[round(t['score'], 4) for t in trials]}; each trial's GET "
              f"/trials/<id>/logs holds the 'Training' plot record and the "
              f"epoch losses "
              f"{[[round(v, 4) for v in losses[t['id']]] for t in trials]}; "
              f"K1, K2, K3 launched {launches_b[:3]} times, all on wgmma; "
              f"chip_utilization {util_max} while the job ran", flush=True)
        out.update(upload_s=up_s, train_s=train_s,
                   scores=[t["score"] for t in trials],
                   train_launches=launches_b[:3], util_running=util_max)

        cache = Cache(plat.bus)
        best = max(trials, key=lambda t: t["score"])
        window = vimgs[:OPERATOR_WINDOW]

        def deploy(mode):
            """The best trial behind a predictor, its cache, predictor
            and worker built under ``mode``: (job, worker id, host,
            registration)."""
            os.environ[wire.PACKED_WIRE_ENV] = mode
            wire.reset_for_tests()
            inf = client.create_inference_job(job["id"], max_models=1)
            wait_for(lambda: len(cache.running_workers(inf["id"])) == 1,
                     OPERATOR_WAIT_S, f"(d) the {mode} worker did not "
                     f"register")
            (wid,) = cache.running_workers(inf["id"])
            info = cache.running_worker_info(inf["id"])[wid]
            host = client.get_inference_job(inf["id"])["predictor_host"]
            return inf, wid, host, info

        def serve_window(host):
            """The window's images, one request each from one client, in
            order: (answers, queries/s, p50 ms, p99 ms)."""
            answers, lat = [], []
            t0 = time.perf_counter()
            for img in window:
                st, dt, ans = ask(host, img, 120)
                check(st == 200 and ans is not None,
                      f"(d) /predict answered {st}")
                answers.append(ans)
                lat.append(dt)
            secs = time.perf_counter() - t0
            lat.sort()
            return (np.asarray(answers, np.float64), len(lat) / secs,
                    percentile(lat, 50) * 1e3, percentile(lat, 99) * 1e3)

        def wire_samples():
            out = []
            for name in WIRE_FAMILIES:
                fam = metrics.registry().find(name)
                out.extend(fam.samples() if fam is not None else ())
            return out

        def undeploy(inf):
            client.stop_inference_job(inf["id"])
            wait_for(lambda: not cache.running_workers(inf["id"])
                     and not plat.services.active_inference_workers(
                         inf["id"]), OPERATOR_WAIT_S,
                     "(d) the deployment did not stop")

        # (d, first half) The wire off: the earlier phases' wire series
        # are dropped, so what exists after the window is this one's.
        for name in WIRE_FAMILIES:
            fam = metrics.registry().find(name)
            if fam is not None:
                fam.remove()
        inf_off, wid_off, host_off, info_off = deploy("off")

        # (c) The workers' logs: the train worker's and this inference
        # worker's; another user is refused.
        svcs = client.get_services()
        train_svc = [x for x in svcs if x["service_type"] == "TRAIN"]
        check(train_svc and any(x["id"] == wid_off for x in svcs),
              f"(c) services {svcs}")
        tails = {what: client.get_service_logs(sid) for what, sid in
                 (("train", train_svc[0]["id"]), ("inference", wid_off))}
        client.create_user("peek@example.com", "pw", UserType.APP_DEVELOPER)
        other = Client(admin_port=port)
        other.login("peek@example.com", "pw")
        refused = []
        for sid in (train_svc[0]["id"], wid_off):
            try:
                other.get_service_logs(sid)
                refused.append(200)
            except ClientError as e:
                refused.append(e.status)
        check(all(t["captured"] and t["log"].strip() for t in tails.values())
              and "trial" in tails["train"]["log"]
              and wid_off in tails["inference"]["log"]
              and refused == [403, 403] and other.get_services() == [],
              f"(c) tails {tails}, another user {refused}")
        print(f"operator: (c) GET /services/<id>/logs: the train worker's "
              f"tail {len(tails['train']['log'])} bytes "
              f"({len(tails['train']['log'].splitlines())} lines, its "
              f"trials' records), the inference worker's "
              f"{len(tails['inference']['log'])} bytes; another user sees no "
              f"service and gets {refused} for both logs", flush=True)

        # (d) Served with the wire off, then on.
        off_ans, off_qps, off_p50, off_p99 = serve_window(host_off)
        off_samples = wire_samples()
        check(info_off["wire"] == [] and off_samples == []
              and not wire.counting(),
              f"(d) off: registration {info_off}, wire series "
              f"{off_samples}")
        undeploy(inf_off)
        inf_on, wid_on, host_on, info_on = deploy("on")
        on_ans, on_qps, on_p50, on_p99 = serve_window(host_on)
        on_bytes = series(metrics, "rafiki_tpu_serving_wire_bytes_total",
                          "format")
        check(info_on["wire"] == ["ndbatch1"] and on_bytes.get("packed", 0) > 0
              and on_ans.shape == (OPERATOR_WINDOW, n_classes)
              and np.isfinite(on_ans).all()
              and np.abs(on_ans.sum(axis=1) - 1.0).max() < 1e-4,
              f"(d) on: registration {info_on}, wire bytes {on_bytes}")
        diff = np.abs(off_ans - on_ans).max()
        check(np.array_equal(off_ans, on_ans),
              f"(d) the wire off and on answered apart by {diff}")
        qid = cache.send_query(wid_on, window[0])
        replies = cache.gather_predictions(qid, 1, timeout=30.0)
        check(len(replies) == 1 and replies[0]["worker_id"] == wid_on
              and np.array_equal(np.asarray(replies[0]["prediction"],
                                            np.float64), on_ans[0]),
              f"(d) send_query answered {replies}")
        for mode, qps, p50, p99 in (("off", off_qps, off_p50, off_p99),
                                    ("on", on_qps, on_p50, on_p99)):
            print("operator: (d) window " + json.dumps({
                "packed_wire": mode, "requests": OPERATOR_WINDOW,
                "clients": 1, "queries_per_s": round(qps, 2),
                "p50_ms": round(p50, 3), "p99_ms": round(p99, 3)}),
                flush=True)
        print(f"operator: (d) the best trial (score {best['score']:.4f}) "
              f"deployed with the packed wire off (the worker offers "
              f"{info_off['wire']}, no rafiki_tpu_serving_wire_bytes_total "
              f"series) and then on (offers {info_on['wire']}, "
              f"{on_bytes} wire bytes by format): the {OPERATOR_WINDOW} "
              f"answers bit for bit equal; Cache.send_query to the live "
              f"worker and gather_predictions gave the /predict answer "
              f"for the first image, bit for bit", flush=True)
        out.update(off_qps=off_qps, off_p99_ms=off_p99, on_qps=on_qps,
                   on_p99_ms=on_p99)

        # (e) The dashboard and every route it fetches.
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                      timeout=60)
        html = page.read().decode()
        ctype = page.headers.get("Content-Type", "")
        ids = {"/services/<x>/logs": wid_on,
               "/inference_jobs/<x>/stats": inf_on["id"],
               "/train_jobs/<x>/trials": job["id"],
               "/trials/<x>/logs": best["id"],
               "/trace/<x>": "0" * 32}
        fetched = dashboard_fetches(html)
        statuses = {}
        for method, path in fetched:
            concrete = (ids[path] if method == "GET" and path in ids
                        else "nope").join(path.split("<x>")) \
                if "<x>" in path else path
            statuses[f"{method} {path}"] = admin_status(port, method,
                                                        concrete, token)
        check(page.status == 200 and ctype.startswith("text/html")
              and html == dashboard_html()
              and all(st != 404 for st in statuses.values())
              and all(st == 200 for k, st in statuses.items()
                      if k.startswith("GET "))
              and len(fetched) >= 20,
              f"(e) GET / {page.status} {ctype}; routes {statuses}")
        print(f"operator: (e) GET / answered {page.status} {ctype} without "
              f"a token; the page's {len(fetched)} requests answered "
              f"{statuses} with the admin's token (each GET with a live id, "
              f"each POST with an unknown id or no body)", flush=True)

        # (f) Utilization: above 0 while the job ran, 0 once it and the
        # deployment stopped.
        undeploy(inf_on)
        wait_for(lambda: plat.services.chip_utilization() == 0.0,
                 OPERATOR_WAIT_S, "(f) chips still held")
        util_after = plat.services.chip_utilization()
        check(util_max > 0 and util_after == 0.0,
              f"(f) utilization {util_max} then {util_after}")
        print(f"operator: (f) ServicesManager.chip_utilization "
              f"{util_max} while the job ran, {util_after} once it and the "
              f"deployments stopped", flush=True)
    finally:
        if plat is not None:
            plat.shutdown()
        os.environ.clear()
        os.environ.update(saved_env)
        wire.reset_for_tests()
        tmp.cleanup()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(launches[0] > 0 and all(launches[3 + i] == launches[i]
                                  for i in range(3)),
          f"the operator phase launched K1-K3 {launches}")
    check(phase_s <= OPERATOR_MAX_S,
          f"the operator phase took {phase_s:.1f} s")
    print(f"operator: K1, K2 and K3 launched {launches[:3]} times in the "
          f"phase (the trials' steps, captures and evaluations, and the "
          f"two workers' runner builds; replays run uncounted), all on "
          f"wgmma; phase took {phase_s:.1f} s on {card}", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def param_dist(np, a, b):
    """The largest |a - b| over two parameter dicts' tensors (``_meta``
    entries left out)."""
    return max(float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max())
               for k in a if not k.startswith("_"))


def trial_records(meta, trial_id):
    return [x["record"] for x in meta.get_trial_logs(trial_id)]


def record_epochs(recs):
    return [r["values"]["epoch"] for r in recs if r["type"] == "values"
            and "epoch" in r["values"]]


def record_msgs(recs):
    return [r["values"]["msg"] for r in recs if r["type"] == "values"
            and "msg" in r["values"]]


class _Died(Exception):
    pass


def search_phase(torch, np, attn, card, zoo2):
    """Checkpoint resume and the trial pipeline on the card: (a) a ViT
    trial that dies after epoch 1 resumes its crash checkpoint
    (``RAFIKI_TPU_CKPT=1``) and ends where an uninterrupted run ends,
    within the card's own run-to-run spread; (b) an ASHA job through
    ``LocalPlatform`` whose promotions resume their rungs' scoped
    checkpoints, its top configuration held against an uninterrupted
    9-epoch run; (c) a PBT job, round 2 warm-starting from the
    population; (d) both through the train worker's prefetch and
    pipelined persist tail, and a worker's close refunding its
    prefetched proposal; (e) the transformer tagger's rung resume.
    Returns the phase's numbers and K1-K3 launches."""
    import os
    import statistics

    from rafiki_torch.advisor import AshaAdvisor
    from rafiki_torch.advisor.base import Proposal
    from rafiki_torch.bus import connect
    from rafiki_torch.constants import (ServiceStatus, ServiceType,
                                        TaskType, TrialStatus, UserType)
    from rafiki_torch.datasets import make_synthetic_corpus_dataset
    from rafiki_torch.model.logger import logger
    from rafiki_torch.models import TorchTransformerTagger
    from rafiki_torch.observe import phases
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.store import CheckpointManager, MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class
    from rafiki_torch.worker.runner import TrialRunner
    from rafiki_torch.worker.train import TrainWorker

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    timgs, tlabels = zoo2["operator"]["train"]
    vimgs, vlabels = zoo2["lifecycle"]["val"]
    n_classes = zoo2["operator"]["n_classes"]
    vit_cls = load_model_class("SearchViT", SEARCH_VIT_SOURCE)
    saved_env = dict(os.environ)
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_search_")
    plat = None
    try:
        train = os.path.join(tmp.name, "train.npz")
        val = os.path.join(tmp.name, "val.npz")
        np.savez(train, images=timgs[:SEARCH_TRAIN],
                 labels=tlabels[:SEARCH_TRAIN], n_classes=n_classes)
        np.savez(val, images=vimgs[:SEARCH_VAL], labels=vlabels[:SEARCH_VAL],
                 n_classes=n_classes)
        steps = SEARCH_TRAIN // 256

        # (a) Crash resume.
        t0 = time.perf_counter()
        knobs = vit_cls.validate_knobs(dict(SEARCH_KNOBS,
                                            max_epochs=SEARCH_EPOCHS))
        runs = []
        for _ in range(2):
            m = vit_cls(device="cuda", **knobs)
            m.train(train)
            runs.append(m.dump_parameters())
            m.destroy()
        spread = param_dist(np, runs[0], runs[1])
        os.environ["RAFIKI_TPU_CKPT"] = "1"
        meta = MetaStore(os.path.join(tmp.name, "a.db"))
        params = ParamStore(os.path.join(tmp.name, "a-params"))
        proposal = Proposal(trial_no=1, knobs=dict(knobs))

        class Proposed:
            """The advisor side of a proposal that is run twice."""

            def feedback(self, p, score):
                pass

            def forget(self, p):
                pass

        runner = TrialRunner(vit_cls, Proposed(), train, val, meta, params,
                             "search-a", device="cuda")

        def dies(rec):
            if rec.get("type") == "values" \
                    and rec["values"].get("epoch") == 2:
                raise _Died("the worker died once epoch 1 was saved")

        prior = logger.current_sink()
        logger.set_sink(dies)
        try:
            dead = runner.run_one(proposal)
        finally:
            logger.set_sink(prior)
        root = os.path.join(params.params_dir, "ckpt")
        dirs = os.listdir(root)
        saved = (CheckpointManager(os.path.join(root, dirs[0])).steps()
                 if len(dirs) == 1 else dirs)
        check(dead["status"] == TrialStatus.ERRORED and saved == [0, 1],
              f"(a) the dying trial {dead['status']}, checkpoints {saved}")
        t_res = time.perf_counter()
        row = runner.run_one(proposal)
        resume_s = time.perf_counter() - t_res
        recs = trial_records(meta, row["id"])
        got = params.load(row["params_id"]) if row["params_id"] else {}
        dist = param_dist(np, got, runs[0]) if got else math.inf
        check(row["status"] == TrialStatus.COMPLETED
              and "resumed from checkpoint epoch 1" in record_msgs(recs)
              and record_epochs(recs) == [2] and os.listdir(root) == [],
              f"(a) the rerun {row['status']}, epochs "
              f"{record_epochs(recs)}, messages {record_msgs(recs)}, "
              f"left {os.listdir(root)}")
        check(dist <= spread,
              f"(a) the resumed run ends {dist} from the uninterrupted "
              f"one, two uninterrupted runs {spread} apart")
        os.environ.pop("RAFIKI_TPU_CKPT")
        params.close()
        meta.close()
        print(f"search: (a) crash resume: two uninterrupted {SEARCH_EPOCHS}-"
              f"epoch ViT runs (6 blocks, d_model 128, batch 256, {steps} "
              f"steps an epoch) lie {spread:.3g} apart (largest |Δ| of a "
              f"parameter: the card's run-to-run spread); under "
              f"RAFIKI_TPU_CKPT=1 a TrialRunner trial died once epoch 1 "
              f"was logged and checkpointed (ckpt_0, ckpt_1 on disk), and "
              f"its proposal run again logged 'resumed from checkpoint "
              f"epoch 1', trained only epoch 2 ({resume_s:.2f} s with its "
              f"evaluation and persist) and ends {dist:.3g} from the first "
              f"uninterrupted run; its directory went with the trial; "
              f"(a) took {time.perf_counter() - t0:.1f} s on {card}",
              flush=True)
        out.update(spread=spread, crash_dist=dist)

        # (b)-(d) ASHA and PBT jobs through the platform's train worker.
        plat = LocalPlatform(workdir=os.path.join(tmp.name, "node"),
                             supervise_interval=0)
        user = plat.admin.create_user("search@example.com", "pw",
                                      UserType.MODEL_DEVELOPER)
        model = plat.admin.create_model(
            user["id"], "vit-search", TaskType.IMAGE_CLASSIFICATION,
            "SearchViT", model_source=SEARCH_VIT_SOURCE)

        def run_job(advisor_type, n):
            """(job, sub-job, trials by number, seconds, persist tail
            seconds, the advisor service's advisor)."""
            before = phases.phase_totals()["persist"]
            t0 = time.perf_counter()
            job = plat.admin.create_train_job(
                user["id"], f"search-{advisor_type}",
                TaskType.IMAGE_CLASSIFICATION, [model["id"]],
                {"MODEL_TRIAL_COUNT": n}, train, val,
                advisor_type=advisor_type)
            (sub,) = plat.meta.get_sub_train_jobs(job["id"])
            advisor = None
            for w in plat.meta.get_train_job_workers(sub["id"]):
                svc = plat.meta.get_service(w["service_id"])
                if svc["service_type"] == ServiceType.ADVISOR:
                    advisor = plat.container.get(
                        svc["container_id"] or svc["id"]).advisor
            check(plat.admin.wait_until_train_job_done(
                job["id"], timeout=SEARCH_WAIT_S, poll=0.05),
                f"the {advisor_type} job did not end")
            secs = time.perf_counter() - t0
            persist = phases.phase_totals()["persist"]
            trials = sorted(plat.meta.get_trials_of_train_job(job["id"]),
                            key=lambda t: t["no"])
            check(len(trials) == n and all(
                t["status"] == TrialStatus.COMPLETED for t in trials),
                f"the {advisor_type} job's trials "
                f"{[(t['status'], t.get('error')) for t in trials]}")
            return (job, sub, trials, secs,
                    (persist["sum"] - before["sum"],
                     persist["count"] - before["count"]), advisor)

        def gaps(trials):
            """Seconds from each trial's last epoch record to the next
            trial's first record (its train start): its evaluation, its
            persist hand-off, the next proposal and the next model's
            build."""
            spans = []
            for t in trials:
                recs = trial_records(plat.meta, t["id"])
                spans.append((min(r["time"] for r in recs),
                              max(r["time"] for r in recs
                                  if r["type"] == "values"
                                  and "epoch" in r["values"])))
            return [b[0] - a[1] for a, b in zip(spans, spans[1:])]

        # (b) ASHA.
        t0 = time.perf_counter()
        job, sub, trials, asha_s, asha_persist, asha_adv = run_job(
            "asha", SEARCH_ASHA_TRIALS)
        by_scope, trained, recorded, bad = {}, 0, 0, []
        for t in trials:
            scope = t["proposal"]["meta"]["ckpt_scope"]
            budget = t["knobs"]["max_epochs"]
            recs = trial_records(plat.meta, t["id"])
            prev = by_scope.get(scope, 0)
            epochs = record_epochs(recs)
            resumed = f"resumed from checkpoint epoch {prev - 1}" in \
                record_msgs(recs)
            if epochs != list(range(prev, budget)) or \
                    (prev > 0) != resumed or budget not in (1, 3, 9):
                bad.append((t["no"], scope, prev, budget, epochs,
                            record_msgs(recs)))
            by_scope[scope] = budget
            trained += len(epochs)
            recorded += budget
        budgets = [t["knobs"]["max_epochs"] for t in trials]
        check(not bad and 9 in budgets,
              f"(b) rungs {budgets}; trials off their rung: {bad}")
        top = [t for t in trials if t["knobs"]["max_epochs"] == 9][0]
        left = [n for n in os.listdir(os.path.join(plat.params.params_dir,
                                                   "ckpt"))
                if n.startswith(f"{sub['id']}-asha-cfg-")] \
            if os.path.isdir(os.path.join(plat.params.params_dir, "ckpt")) \
            else []
        check(left == [], f"(b) scoped checkpoints left: {left}")
        m = vit_cls(device="cuda", **vit_cls.validate_knobs(
            dict(top["knobs"])))
        m.train(train, schedule_total_epochs=9)
        top_dist = param_dist(np, plat.params.load(top["params_id"]),
                              m.dump_parameters())
        m.destroy()
        check(top_dist <= spread,
              f"(b) the top rung ends {top_dist} from an uninterrupted "
              f"9-epoch run, beyond (a)'s spread {spread}")
        print(f"search: (b) ASHA through LocalPlatform, {SEARCH_ASHA_TRIALS} "
              f"trials in {asha_s:.2f} s, rungs {budgets} (ladder 1, 3, 9: "
              f"max_epochs IntegerKnob(1, 9), eta 3); every promoted trial "
              f"logged the resume of its configuration's scoped checkpoint "
              f"and epochs from its last rung's end, and recorded the "
              f"cumulative budget; epochs trained {trained} against "
              f"{recorded} recorded ({recorded - trained} saved by the "
              f"resumes); the top configuration (score "
              f"{top['score']:.4f}) trained again uninterrupted for 9 "
              f"epochs under schedule_total_epochs 9 ends {top_dist:.3g} "
              f"from its rung chain; no asha-cfg-* directory left after "
              f"the budget; (b) took {time.perf_counter() - t0:.1f} s",
              flush=True)
        out.update(asha_s=asha_s, asha_trained=trained,
                   asha_recorded=recorded, top_dist=top_dist)

        # (c) PBT.
        t0 = time.perf_counter()
        n_pbt = 2 * SEARCH_PBT_POPULATION
        job_c, sub_c, trials_c, pbt_s, pbt_persist, pbt_adv = run_job(
            "pbt", n_pbt)
        pop = {f"pbt-{i}" for i in range(SEARCH_PBT_POPULATION)}
        round2 = trials_c[SEARCH_PBT_POPULATION:]
        warm = [trial_warm_starts(plat.meta, t["id"]) for t in round2]
        exploited = sum(t["proposal"]["meta"]["params_scope"]
                        != t["proposal"]["meta"]["params_save_scope"]
                        for t in round2)
        check(all(t["knobs"]["max_epochs"] == 1
                  for t in trials_c[:SEARCH_PBT_POPULATION])
              and all(t["knobs"]["max_epochs"] == 2 for t in round2)
              and all(w and w[0] > 0 for w in warm)
              and all(t["proposal"]["meta"]["params_scope"] in pop
                      for t in round2),
              f"(c) budgets {[t['knobs']['max_epochs'] for t in trials_c]},"
              f" warm starts {warm}, scopes "
              f"{[t['proposal']['meta'] for t in round2]}")
        print(f"search: (c) PBT through LocalPlatform, population "
              f"{SEARCH_PBT_POPULATION}, one epoch a round, two rounds: "
              f"{n_pbt} trials in {pbt_s:.2f} s; every round-2 trial "
              f"warm-started {warm[0][0]} tensors from a member's scope "
              f"and recorded max_epochs 2; {exploited} of "
              f"{SEARCH_PBT_POPULATION} exploited a winner (retrieved "
              f"another member's scope); scores "
              f"{[round(t['score'], 4) for t in trials_c]}; (c) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update(pbt_s=pbt_s, exploited=exploited)

        # (d) The pipeline: the jobs' gaps and tails; a worker's close.
        t0 = time.perf_counter()
        asha_gaps, pbt_gaps = gaps(trials), gaps(trials_c)
        balanced = [
            asha_adv._pending == {}
            and asha_adv._trial_no - asha_adv._forgotten
            == SEARCH_ASHA_TRIALS,
            all(v == 0 for v in pbt_adv._inflight.values())
            and pbt_adv._trial_no - pbt_adv._forgotten == n_pbt]
        check(all(balanced), f"(d) the advisors' books {balanced}")
        meta = MetaStore(os.path.join(tmp.name, "d.db"))
        params = ParamStore(os.path.join(tmp.name, "d-params"))
        u = meta.create_user("d@example.com", "-", UserType.MODEL_DEVELOPER)
        row = meta.create_model(u["id"], "vit", TaskType.IMAGE_CLASSIFICATION,
                                "SearchViT", {},
                                model_source=SEARCH_VIT_SOURCE)
        job_d = meta.create_train_job(u["id"], "d",
                                      TaskType.IMAGE_CLASSIFICATION,
                                      {"MODEL_TRIAL_COUNT": 2}, train, val,
                                      status="RUNNING")
        sub_d = meta.create_sub_train_job(job_d["id"], row["id"],
                                          status="RUNNING")
        svc = meta.create_service(ServiceType.TRAIN, ServiceStatus.STARTED)
        adv = AshaAdvisor(vit_cls.get_knob_config(), seed=SEED)
        worker = TrainWorker(svc["id"], sub_d["id"], meta, params,
                             connect(""), advisor=adv, device="cuda")
        worker.start()
        worker.join(SEARCH_WAIT_S)
        done_d = meta.get_trials(sub_d["id"], status=TrialStatus.COMPLETED)
        check(not worker.running and len(done_d) == 2
              and adv._trial_no == 3 and adv._forgotten == 1
              and adv._pending == {},
              f"(d) the worker's trials {len(done_d)}, proposals "
              f"{adv._trial_no}, refunds {adv._forgotten}, pending "
              f"{adv._pending}")
        params.close()
        meta.close()
        for name, g, (ps, pn) in (("ASHA", asha_gaps, asha_persist),
                                  ("PBT", pbt_gaps, pbt_persist)):
            print(f"search: (d) {name} job: median gap from a trial's last "
                  f"epoch to the next trial's train start "
                  f"{statistics.median(g):.3f} s (min {min(g):.3f}, max "
                  f"{max(g):.3f}; the evaluation, the persist hand-off, "
                  f"the prefetched proposal and the next model's build); "
                  f"persist tail {ps:.3f} s over {pn} trials, on the "
                  f"persist thread", flush=True)
        print(f"search: (d) both jobs ran with the worker's prefetch and "
              f"pipelined persist tail (its defaults); the advisors' books "
              f"balance (ASHA nothing pending, PBT nothing in flight); a "
              f"worker of its own with an uncapped ASHA advisor ran its "
              f"2-trial budget and its close forgot the third, prefetched "
              f"proposal (1 refund, nothing pending); (d) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update(asha_gap_s=statistics.median(asha_gaps),
                   pbt_gap_s=statistics.median(pbt_gaps),
                   asha_persist_s=asha_persist[0],
                   pbt_persist_s=pbt_persist[0])

        # (e) The tagger's rung resume.
        t0 = time.perf_counter()
        corpus = make_synthetic_corpus_dataset(
            os.path.join(tmp.name, "wsj"), seed=SEED, name="wsj",
            **SEARCH_CORPUS)
        tknobs = dict(ZOO2_TAGGER, n_layers=SEARCH_TAGGER_LAYERS,
                      max_epochs=2)
        before = launch_counts(attn)
        truns = []
        for _ in range(2):
            m = TorchTransformerTagger(device="cuda", **tknobs)
            m.train(corpus[0])
            truns.append(m.dump_parameters())
        tspread = param_dist(np, truns[0], truns[1])
        ck = os.path.join(tmp.name, "tagger-ck")
        m = TorchTransformerTagger(device="cuda", **dict(tknobs,
                                                         max_epochs=1))
        m.train(corpus[0], checkpoint_dir=ck, checkpoint_final_epoch=True,
                schedule_total_epochs=2)
        m = TorchTransformerTagger(device="cuda", **tknobs)
        _, eps = logged(m.train, corpus[0], checkpoint_dir=ck,
                        checkpoint_final_epoch=True, schedule_total_epochs=2)
        tdist = param_dist(np, m.dump_parameters(), truns[0])
        tl = [a - b for a, b in zip(launch_counts(attn), before)]
        check([e["epoch"] for e in eps] == [1] and tdist <= tspread
              and all(tl[i] > 0 and tl[3 + i] == tl[i] for i in range(3)),
              f"(e) the resumed rung's epochs {eps}, distance {tdist}, two "
              f"uninterrupted runs {tspread}; launches {tl}")
        print(f"search: (e) transformer tagger (d_model 256, 4 heads of 64, "
              f"{SEARCH_TAGGER_LAYERS} layers, max_len 128, dropout 0.1, "
              f"kv_mask), {SEARCH_CORPUS['n_train']} sentences (16 steps of "
              f"64): two uninterrupted 2-epoch runs lie {tspread:.3g} apart; "
              f"a 1-epoch rung, then the 2-epoch rung resumed (epoch 1 "
              f"only), ends {tdist:.3g} from the first; K1, K2, K3 "
              f"launched {tl[:3]} times, all wgmma; (e) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update(tagger_spread=tspread, tagger_dist=tdist)
    finally:
        if plat is not None:
            plat.shutdown()
        os.environ.clear()
        os.environ.update(saved_env)
        tmp.cleanup()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(all(launches[i] > 0 and launches[3 + i] == launches[i]
              for i in range(3)),
          f"the search phase launched K1-K3 {launches}")
    check(phase_s <= SEARCH_MAX_S, f"the search phase took {phase_s:.1f} s")
    print(f"search: K1, K2 and K3 launched {launches[:3]} times in the "
          f"phase (warm-up steps, captures and evaluations of the ViT "
          f"trials, the tagger's eager steps; replays run uncounted), all "
          f"on wgmma; phase took {phase_s:.1f} s on {card}", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out

def staged_digests(torch, np):
    """{key: sha-256 of the tensor's bytes} of every staging-cache
    entry."""
    import hashlib

    from rafiki_torch.model import torch_model

    out = {}
    for key, (value, _, _) in list(torch_model._STAGE_CACHE._entries.items()):
        h = hashlib.sha256()
        for t in value:
            h.update(t.cpu().numpy().tobytes())
        out[key] = h.hexdigest()
    return out


def data_phase(torch, np, attn, card, zoo2, lm_params):
    """Data staging and real data on the card: (a) both taggers trained
    on the bundled English corpus against their bands, the transformer's
    K1-K3 launches against its steps and the kernels timed at its shape;
    (b) a 4-trial ViT job through ``TrialRunner`` with both caches on (2
    misses and 6 hits each, the staged tensors unchanged) and again with
    both off, bit for bit; (c) a trial on the per-chunk path, bit for bit
    the staged one, caching nothing; (d) the flagship LM's evaluation on
    the staged stream (a miss, then a hit) and on the host path, equal.
    Returns the phase's numbers and K1-K3 launches."""
    import os

    from rafiki_torch import accuracy_parity
    from rafiki_torch.advisor.base import Proposal
    from rafiki_torch.constants import TrialStatus
    from rafiki_torch.datasets import make_synthetic_token_dataset
    from rafiki_torch.model import dataset as mds
    from rafiki_torch.model import torch_model
    from rafiki_torch.model.dataset import (load_corpus_dataset,
                                            load_token_dataset)
    from rafiki_torch.models import TorchTransformerLM, TorchTransformerTagger
    from rafiki_torch.observe import phases
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class
    from rafiki_torch.worker.runner import TrialRunner

    t_phase = time.perf_counter()
    reset_launch_counts(attn)
    saved_env = dict(os.environ)
    saved_chunk = torch_model.CHUNK_STEPS
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    out = {}

    def counts(cache):
        c = phases.cache_counts(cache)
        return {e: c.get(e, 0) for e in ("hit", "miss", "evict")}

    def gauge(cache):
        return int(phases._reg()[f"{cache}_cache_bytes"].samples()[0][1])

    try:
        # (a) Both taggers on the bundled English corpus.
        t0 = time.perf_counter()
        before = launch_counts(attn)
        rows = accuracy_parity.corpus_rows(os.path.join(tmp.name, "pos"),
                                           "cuda")
        got = [a - b for a, b in zip(launch_counts(attn), before)]
        train = load_corpus_dataset(os.path.join(tmp.name, "pos",
                                                 "pos_train.zip"))
        val = load_corpus_dataset(os.path.join(tmp.name, "pos",
                                               "pos_val.zip"))
        tknobs = dict(accuracy_parity.CORPUS_ROWS[1][1])
        b, t, L = tknobs["batch_size"], tknobs["max_len"], tknobs["n_layers"]
        steps = train.size // b * tknobs["max_epochs"]
        bucket = 1 << (val.size - 1).bit_length()
        want = [L * steps + L, L * steps, L * steps]
        check(got[:3] == want and got[3:] == got[:3],
              f"(a) the tagger launched K1-K3 {got}, not {want} on wgmma")
        for row in rows:
            check(row["ok"], f"(a) {row['model']} val token accuracy "
                  f"{row['acc']:.4f} below its band {row['band']}")
            print(f"data: (a) {row['model']} on the bundled English corpus "
                  f"({train.size} train and {val.size} val sentences, "
                  f"{len(train.tag_names)} tags): val token accuracy "
                  f"{row['acc']:.4f} against its band {row['band']} (the "
                  f"reference measured 0.913-0.920 and 0.871-0.889 over "
                  f"three split seeds), {row['seconds']:.2f} s on {card}",
                  flush=True)
        print(f"data: (a) the transformer tagger (d_model 128, 4 heads of "
              f"32, {L} layers, batch {b}, bf16, kv_mask) pads every "
              f"sentence to max_len {t}: K1-K3 launched at ({b},4,{t},{t},"
              f"32) in training and at ({bucket},4,{t},{t},32) in its "
              f"evaluation, K1 {got[0]}, K2 {got[1]}, K3 {got[2]} times "
              f"({L} each a step of {steps}, K1 {L} more for the "
              f"evaluation), all wgmma; (a) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        m = TorchTransformerTagger(device="cuda", **tknobs)
        net = m._new_net(train.tag_names).eval()
        ids, _ = m._encode(train.sentences[:b])
        ids = torch.from_numpy(ids).to("cuda")
        calls = []
        with torch.no_grad():
            x_in = net.Embed_0(ids) + net.pe[None, :t].to(torch.bfloat16)
            net._EncoderBlock_0(x_in, recording(m.attention, calls),
                                ids != 0)
        q, k, v, mask = calls[0]
        with uncounted(attn):
            kern = zoo2_kernels(torch, attn, card, "real-corpus tagger", q,
                                k, v, mask, tag="data: (a)")
        del m, net, calls, q, k, v
        out.update(corpus={r["model"]: r["acc"] for r in rows},
                   tagger_launches=got[:3], kernels=kern)

        # (b) The caches over a 4-trial ViT job, on and off.
        t0 = time.perf_counter()
        timgs, tlabels = zoo2["operator"]["train"]
        vimgs, vlabels = zoo2["lifecycle"]["val"]
        n_classes = zoo2["operator"]["n_classes"]
        vit_cls = load_model_class("SearchViT", SEARCH_VIT_SOURCE)
        train_p = os.path.join(tmp.name, "train.npz")
        val_p = os.path.join(tmp.name, "val.npz")
        np.savez(train_p, images=timgs[:SEARCH_TRAIN],
                 labels=tlabels[:SEARCH_TRAIN], n_classes=n_classes)
        np.savez(val_p, images=vimgs[:SEARCH_VAL],
                 labels=vlabels[:SEARCH_VAL], n_classes=n_classes)
        proposals = [Proposal(trial_no=i + 1, knobs=vit_cls.validate_knobs(
            dict(SEARCH_KNOBS, learning_rate=lr, max_epochs=1)))
            for i, lr in enumerate(DATA_LRS[:DATA_TRIALS])]

        class Proposed:
            def feedback(self, p, score):
                pass

            def forget(self, p):
                pass

        def job(name):
            """Each proposal once through one runner: (parameters,
            stage seconds, train seconds) a trial."""
            meta = MetaStore(os.path.join(tmp.name, f"{name}.db"))
            params = ParamStore(os.path.join(tmp.name, f"{name}-params"))
            runner = TrialRunner(vit_cls, Proposed(), train_p, val_p, meta,
                                 params, f"data-{name}", device="cuda")
            res = []
            for p in proposals:
                ph0 = phases.phase_totals()
                row = runner.run_one(p)
                ph1 = phases.phase_totals()
                check(row["status"] == TrialStatus.COMPLETED,
                      f"(b) a {name} trial {row['status']}")
                res.append((params.load(row["params_id"]),
                            ph1["stage"]["sum"] - ph0["stage"]["sum"],
                            ph1["train"]["sum"] - ph0["train"]["sum"]))
            params.close()
            meta.close()
            return res

        mds.clear_dataset_cache()
        torch_model.clear_stage_cache()
        d0, s0 = counts("dataset"), counts("stage")
        cached = job("cached")
        dd = {e: counts("dataset")[e] - d0[e] for e in d0}
        sd = {e: counts("stage")[e] - s0[e] for e in s0}
        check(dd == sd == {"hit": 6, "miss": 2, "evict": 0},
              f"(b) dataset cache {dd}, stage cache {sd}")
        digests = staged_digests(torch, np)
        check(len(digests) == 2, f"(b) {len(digests)} staged entries")
        bytes_ds, bytes_st = gauge("dataset"), gauge("stage")
        os.environ[mds.DATASET_CACHE_ENV] = "0"
        os.environ[torch_model.STAGE_CACHE_ENV] = "0"
        d1, s1 = counts("dataset"), counts("stage")
        uncached = job("uncached")
        check(counts("dataset") == d1 and counts("stage") == s1,
              "(b) the caches counted events with their budgets at 0")
        for i, (a, c) in enumerate(zip(cached, uncached)):
            dist = param_dist(np, a[0], c[0])
            check(dist == 0, f"(b) trial {i + 1}: cached and uncached "
                  f"parameters {dist} apart")
        check(staged_digests(torch, np) == digests,
              "(b) a staged tensor changed over the 8 trials")
        os.environ.pop(mds.DATASET_CACHE_ENV)
        os.environ.pop(torch_model.STAGE_CACHE_ENV)
        stage_s = [r[1] for r in cached]
        print(f"data: (b) {DATA_TRIALS} one-epoch ViT trials (6 blocks, "
              f"d_model 128, batch 256, {SEARCH_TRAIN} + {SEARCH_VAL} "
              f"images) through one TrialRunner: dataset cache {dd}, stage "
              f"cache {sd}; stage phase seconds trial 1 {stage_s[0]:.4f} "
              f"(train and val copied) against trials 2-4 "
              + ", ".join(f"{x:.6f}" for x in stage_s[1:])
              + f" (hits); gauges: dataset cache {bytes_ds} bytes, stage "
              f"cache {bytes_st} bytes; the same {DATA_TRIALS} trials with "
              f"RAFIKI_TPU_DATASET_CACHE_BYTES=0 and "
              f"RAFIKI_TPU_STAGE_CACHE_BYTES=0 counted no event and ended "
              f"bit for bit equal, trial by trial; the 2 staged entries' "
              f"sha-256 unchanged after all {2 * DATA_TRIALS} trials; (b) "
              f"took {time.perf_counter() - t0:.1f} s on {card}", flush=True)
        out.update(stage_s=stage_s, dataset_cache_bytes=bytes_ds,
                   stage_cache_bytes=bytes_st)

        # (c) The per-chunk path.
        t0 = time.perf_counter()
        set_bytes = SEARCH_TRAIN * int(np.prod(timgs.shape[1:]))
        torch_model.CHUNK_STEPS = DATA_CHUNK_STEPS
        loader_cls = torch_model._ChunkLoader
        real_load = loader_cls.load
        gathers = []

        def timed_load(self, sel):
            t_load = time.perf_counter()
            real_load(self, sel)
            gathers[-1] += time.perf_counter() - t_load

        def train_once(chunked, path=train_p, evaluate=True, event="hit"):
            """Trial 1's knobs, trained by one call on ``path``: (its
            seconds to the end of its device work, parameters)."""
            if chunked:
                os.environ[torch_model.STAGE_BYTES_ENV] = str(set_bytes - 1)
            else:
                os.environ.pop(torch_model.STAGE_BYTES_ENV, None)
            gathers.append(0.0)
            m = vit_cls(device="cuda", **proposals[0].knobs)
            ph0, s0 = phases.phase_totals()["stage"]["count"], counts("stage")
            torch.cuda.synchronize()
            t_tr = time.perf_counter()
            m.train(path)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_tr
            staged = (phases.phase_totals()["stage"]["count"] - ph0,
                      {e: counts("stage")[e] - s0[e] for e in s0})
            none = {"hit": 0, "miss": 0, "evict": 0}
            want = (0, none) if chunked else (1, dict(none, **{event: 1}))
            kind = "per-chunk" if chunked else "staged"
            check(staged == want, f"(c) a {kind} train staged {staged} "
                  f"(phases, events), not {want}")
            if chunked and evaluate:
                # The val set is under the threshold: its evaluation
                # hits (b)'s entry and adds none.
                out["chunk_acc"] = m.evaluate(val_p)
            got = m.dump_parameters()
            m.destroy()
            return secs, got

        loader_cls.load = timed_load
        try:
            info0 = torch_model.stage_cache_info()
            runs = [train_once(c) for c in (False, True, True, False)]
        finally:
            loader_cls.load = real_load
        check(torch_model.stage_cache_info() == info0,
              "(c) the per-chunk trials made a stage-cache entry")
        for i, (_, got) in enumerate(runs):
            dist = param_dist(np, got, cached[0][0])
            check(dist == 0, f"(c) train {i + 1} of 4 "
                  f"({'per-chunk' if i in (1, 2) else 'staged'}) ended "
                  f"{dist} from the staged trial")
        chunk_s = [runs[1][0], runs[2][0]]
        staged_s = [runs[0][0], runs[3][0]]
        batch = proposals[0].knobs["batch_size"]
        n_chunks = -(-(SEARCH_TRAIN // batch) // DATA_CHUNK_STEPS)
        print(f"data: (c) RAFIKI_TPU_STAGE_BYTES={set_bytes - 1} (the set "
              f"is {set_bytes} image bytes): trial 1 again, in turns "
              f"staged, per-chunk, per-chunk, staged; the per-chunk train "
              f"in {n_chunks} chunks of {DATA_CHUNK_STEPS} steps of "
              f"{batch} images gathered into one pinned host buffer "
              f"while the device ran the chunk before, and copied into one "
              f"device buffer: parameters bit for bit the staged trial's "
              f"in all 4, no stage-cache entry (the per-chunk trains no "
              f"stage event; the staged ones hit (b)'s entry), val "
              f"accuracy {out['chunk_acc']:.4f}; train call seconds "
              f"(to the end of its device work) per-chunk "
              + ", ".join(f"{x:.4f}" for x in chunk_s)
              + " against staged "
              + ", ".join(f"{x:.4f}" for x in staged_s)
              + "; host seconds in the per-chunk trains' chunk loads "
              + ", ".join(f"{gathers[i]:.4f}" for i in (1, 2))
              + f"; (c) took {time.perf_counter() - t0:.1f} s on {card}",
              flush=True)
        torch_model.CHUNK_STEPS = saved_chunk
        os.environ.pop(torch_model.STAGE_BYTES_ENV, None)
        out.update(chunk_train_s=chunk_s, staged_train_s=staged_s,
                   chunk_load_s=[gathers[1], gathers[2]])

        # (c) again at full chunks, the loads overlapped against blocking.
        t0 = time.perf_counter()
        big_p = os.path.join(tmp.name, "big.npz")
        n_big = DATA_BIG_CHUNKS * torch_model.CHUNK_STEPS * batch
        np.savez(big_p, images=np.resize(timgs[:SEARCH_TRAIN],
                                         (n_big, *timgs.shape[1:])),
                 labels=np.resize(tlabels[:SEARCH_TRAIN], n_big),
                 n_classes=n_classes)
        big_bytes = n_big * int(np.prod(timgs.shape[1:]))

        def blocking_load(self, sel):
            """The first design's load: the host waits for the queued
            steps, then gathers the chunk and copies it from pageable
            memory, while the device waits."""
            torch.cuda.synchronize()
            t_load = time.perf_counter()
            flat = sel.reshape(-1)
            self.data[:flat.size].copy_(
                torch.from_numpy(self.ds.images[flat]))
            self.labels[:flat.size].copy_(
                torch.from_numpy(self.ds.labels[flat].astype(np.int32)))
            gathers[-1] += time.perf_counter() - t_load

        big = {}
        try:
            # The first staged call loads and stages the set (untimed
            # here: its load and stage misses).
            _, ref = train_once(False, big_p, event="miss")
            for how in ("blocking", "overlapped", "overlapped", "blocking",
                        "staged"):
                if how != "staged":
                    loader_cls.load = timed_load if how == "overlapped" \
                        else blocking_load
                secs, got = train_once(how != "staged", big_p, False)
                loader_cls.load = real_load
                dist = param_dist(np, got, ref)
                check(dist == 0, f"(c) a full-chunk {how} train ended "
                      f"{dist} from the staged one")
                big.setdefault(how, []).append((secs, gathers[-1]))
        finally:
            loader_cls.load = real_load
            os.environ.pop(torch_model.STAGE_BYTES_ENV, None)
            mds.clear_dataset_cache()
            torch_model.clear_stage_cache()

        def pairs(how):
            return ", ".join(f"{a:.4f} (loads {b:.4f})" for a, b in big[how])

        print(f"data: (c) full chunks: {n_big} images ({big_bytes} bytes, "
              f"the search set tiled), one epoch of "
              f"{n_big // batch} steps in {DATA_BIG_CHUNKS} chunks of "
              f"{torch_model.CHUNK_STEPS}, in turns blocking, overlapped, "
              f"overlapped, blocking, staged, all bit for bit the staged "
              f"train: train call seconds with the chunk loads overlapped "
              f"{pairs('overlapped')}, blocking as first designed "
              f"{pairs('blocking')}, staged (a stage hit) "
              f"{big['staged'][0][0]:.4f}; (c) full chunks took "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        out.update(full_chunk_s={k: [a for a, _ in v]
                                 for k, v in big.items()})

        # (d) The flagship LM's staged evaluation.
        t0 = time.perf_counter()
        _, lm_val = make_synthetic_token_dataset(
            os.path.join(tmp.name, "tok"), n_train=1 << 12,
            n_val=DATA_LM_VAL, vocab_size=FLAGSHIP["vocab_size"], seed=SEED)
        knobs = TorchTransformerLM.validate_knobs(FLAGSHIP)
        lm = TorchTransformerLM(device="cuda", **knobs)
        lm.load_parameters(lm_params)
        dims = lm._dims()
        n_l, n_win = FLAGSHIP["n_layers"], min(16, (DATA_LM_VAL - 1)
                                               // dims["t"])
        stream = load_token_dataset(lm_val).ids
        want = torch.from_numpy(np.stack(
            [stream[i * dims["t"]:(i + 1) * dims["t"] + 1]
             for i in range(n_win)]).astype(np.int64)).to("cuda")
        s3 = counts("stage")
        accs, lms, ces, seen = [], [], [], []
        first = None
        windows, forward = lm._eval_windows, lm._forward

        def record_windows(dataset_path):
            seen.append(windows(dataset_path))
            return seen[-1]

        def record_forward(x):
            seen.append(forward(x))
            return seen[-1]

        lm._eval_windows, lm._forward = record_windows, record_forward
        for off in (False, False, True):
            if off:
                os.environ[torch_model.STAGE_CACHE_ENV] = "0"
            k0 = launch_counts(attn)
            t_ev = time.perf_counter()
            accs.append(lm.evaluate(lm_val))
            lms.append(time.perf_counter() - t_ev)
            kd = [a - c for a, c in zip(launch_counts(attn), k0)]
            check(kd == [n_l, 0, 0, n_l, 0, 0],
                  f"(d) an evaluation launched {kd}, not K1 {n_l} on "
                  f"wgmma")
            wins, logits = seen
            seen.clear()
            check(wins.dtype == torch.int64 and torch.equal(wins, want),
                  f"(d) evaluation {len(accs)}'s windows are not the "
                  f"stream's {n_win} windows cut on the host")
            if first is None:
                first = logits
            check(torch.equal(logits, first),
                  f"(d) evaluation {len(accs)}'s logits differ from the "
                  f"first's")
            ces.append(float(torch.nn.functional.cross_entropy(
                logits.flatten(0, 1), wins[:, 1:].flatten())))
            del wins, logits
        del first, want
        os.environ.pop(torch_model.STAGE_CACHE_ENV)
        sd = {e: counts("stage")[e] - s3[e] for e in s3}
        check(sd == {"hit": 1, "miss": 1, "evict": 0},
              f"(d) the LM's stage events {sd}")
        check(accs[0] == accs[1] == accs[2] and 0 <= accs[0] <= 1
              and ces[0] == ces[1] == ces[2] and math.isfinite(ces[0]),
              f"(d) the three evaluations: accuracy {accs}, "
              f"cross-entropy {ces}")
        lm.destroy()
        del lm
        torch.cuda.empty_cache()
        print(f"data: (d) the flagship LM (the train phase's parameters) "
              f"evaluated {n_win} windows of {dims['t']} ids of a "
              f"{DATA_LM_VAL}-id stream three times: staged (a stage miss, "
              f"{lms[0]:.3f} s), staged again (a hit, {lms[1]:.3f} s) and "
              f"with RAFIKI_TPU_STAGE_CACHE_BYTES=0 on the host path "
              f"({lms[2]:.3f} s): each time the windows bit for bit those "
              f"cut here from the stream (ids and targets), the ({n_win}, "
              f"{dims['t']}, {FLAGSHIP['vocab_size']}) f32 logits bit for "
              f"bit the first's, cross-entropy {ces[0]!r} nats and "
              f"next-token accuracy {accs[0]!r} (the 16-step flagship "
              f"ranks no next token of this stream first); K1 {n_l} a "
              f"forward at ({n_win},{dims['h']},{dims['t']},{dims['t']},"
              f"{dims['d'] // dims['h']}) causal, all wgmma; (d) took "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        out.update(lm_acc=accs[0], lm_ce=ces[0], lm_eval_s=lms)
    finally:
        torch_model.CHUNK_STEPS = saved_chunk
        os.environ.clear()
        os.environ.update(saved_env)
        tmp.cleanup()
    launches = launch_counts(attn)
    phase_s = time.perf_counter() - t_phase
    check(all(launches[i] > 0 and launches[3 + i] == launches[i]
              for i in range(3)), f"the data phase launched K1-K3 {launches}")
    check(phase_s <= DATA_MAX_S, f"the data phase took {phase_s:.1f} s")
    print(f"data: K1, K2 and K3 launched {launches[:3]} times in the phase "
          f"(the tagger's eager steps and evaluation, the ViT trials' "
          f"warm-up steps, captures and evaluations, the LM's three "
          f"forwards; replays run uncounted), all on wgmma; phase took "
          f"{phase_s:.1f} s on {card}", flush=True)
    out.update(launches=launches[:3], phase_s=phase_s)
    return out


def par_corpus(np, out_dir):
    """A corpus of PAR_SENTENCES train and PAR_VAL val sentences whose
    lengths are uniform in PAR_LENGTHS, each word with a fixed majority
    tag and 5% of tags at random (``make_synthetic_corpus_dataset``'s
    recipe at these lengths). Returns the two paths."""
    import os

    from rafiki_torch.model.dataset import write_corpus_dataset

    rng = np.random.default_rng(SEED + 21)
    word_tag = rng.integers(0, PAR_TAGS, size=PAR_VOCAB)
    names = [f"TAG{i}" for i in range(PAR_TAGS)]
    paths = []
    for split, n in (("train", PAR_SENTENCES), ("val", PAR_VAL)):
        sents, tags = [], []
        for _ in range(n):
            length = int(rng.integers(PAR_LENGTHS[0], PAR_LENGTHS[1] + 1))
            ids = rng.integers(0, PAR_VOCAB, size=length)
            sents.append([f"w{i}" for i in ids])
            noisy = np.where(rng.random(length) < 0.05,
                             rng.integers(0, PAR_TAGS, size=length),
                             word_tag[ids])
            tags.append([names[t] for t in noisy])
        paths.append(write_corpus_dataset(
            sents, tags, os.path.join(out_dir, f"par_{split}.zip"),
            tag_names=names))
    return paths


def par_step(torch, model, net, ids, lens, tags):
    """One AdamW step of ``model``'s on ``net``, as the corpus loop takes
    it (the masked cross-entropy plus ``train_logits``' term, the
    optimizer over PAR_STEPS steps); returns the loss."""
    import torch.nn.functional as F

    opt = model.create_optimizer(list(net.parameters()), PAR_STEPS)
    step = torch.zeros((), dtype=torch.int64, device="cuda")
    opt.zero_grad()
    out, extra = model.train_logits(net, ids, lens, step)
    mask = (torch.arange(ids.shape[1], device="cuda")[None, :]
            < lens[:, None]).float()
    losses = F.cross_entropy(out.transpose(1, 2), tags, reduction="none")
    loss = (losses * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    if extra is not None:
        loss = loss + extra
    loss.backward()
    opt.step()
    return float(loss.detach())


def par_launches(mesh, extra, batch, n_layers):
    """K1's launches in one forward of a mode, predicted from the mesh
    (each of K2 and K3 as many in its backward): none for the ring;
    else one a layer for every dp rank, sp rank and, in the pipeline,
    microbatch (``pp_microbatches``, or the largest divisor of the
    rank's rows up to 4·pp)."""
    dp, pp, sp = (mesh.shape[a] for a in ("dp", "pp", "sp"))
    if sp > 1 and extra.get("sp_schedule", "ring") == "ring":
        return 0
    micro = 1
    if pp > 1:
        rows = batch // dp
        micro = extra.get("pp_microbatches", 0) or min(rows, 4 * pp)
        while rows % micro:
            micro -= 1
    return n_layers * dp * sp * micro


def parallel_phase(torch, np, attn, card):
    """The mesh and intra-trial parallelism on the card: the transformer
    tagger at the widest point of its knob space (PAR_TAGGER) in the
    parallelism tour's seven modes on a mesh of PAR_ENTRIES entries, each
    the one card, bound to the thread as a worker binds its group. Each
    mode against the single-device tagger on the same weights: (a) the
    logits of a fixed batch, (b) one AdamW step's loss and parameters;
    (c) PAR_STEPS steps through ``train`` (first and last loss), its
    K1-K3 launches against the count predicted from the mesh, all
    wgmma; (d) its file loaded into a single-device tagger predicting
    the same tags. K1 and K2 with K3 timed at the Ulysses shape. Returns
    the phase's numbers and K1-K3 launches."""
    import copy

    from rafiki_torch.model.dataset import load_corpus_dataset
    from rafiki_torch.models import TorchTransformerTagger
    from rafiki_torch.parallel.chips import ChipGroup

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_par_")
    group = ChipGroup(indices=(0,) * PAR_ENTRIES)
    b, t, n_l = (PAR_TAGGER[k] for k in ("batch_size", "max_len",
                                         "n_layers"))
    out = {"modes": {}}
    totals = [0] * 6
    try:
        train_path, val_path = par_corpus(np, tmp.name)
        ds = load_corpus_dataset(train_path)
        val = load_corpus_dataset(val_path).sentences
        n_tok = sum(len(x) for x in ds.sentences)
        probe = TorchTransformerTagger(device="cuda", **PAR_TAGGER)
        ids_np, lens_np = probe._encode(ds.sentences)
        tags_np = np.zeros((b, t), np.int64)
        for i, tg in enumerate(ds.tags):
            tags_np[i, :len(tg)] = tg[:t]
        ids = torch.from_numpy(ids_np).cuda()
        lens = torch.from_numpy(lens_np).cuda()
        tags = torch.from_numpy(tags_np).cuda()
        real = ids != 0
        print(f"parallel: corpus of {b} train sentences ({n_tok} tokens, "
              f"lengths {PAR_LENGTHS[0]}-{PAR_LENGTHS[1]} padded to {t}) "
              f"and {len(val)} val, {PAR_VOCAB} words, {PAR_TAGS} tags; "
              f"mesh of {PAR_ENTRIES} entries on {torch.cuda.device_count()} "
              f"card(s)", flush=True)
        singles = {}
        for name, extra in PAR_MODES:
            moe = extra.get("moe_experts", 0)
            if moe not in singles:
                sm = TorchTransformerTagger(device="cuda", moe_experts=moe,
                                            **PAR_TAGGER)
                net0 = sm._new_net(ds.tag_names)
                net1 = copy.deepcopy(net0)
                with uncounted(attn):
                    with torch.no_grad():
                        want = sm.logits(net0, ids, lens).float()
                    loss1 = par_step(torch, sm, net1, ids, lens, tags)
                check(sm.mesh.size == 1, "the single-device tagger's mesh "
                      f"has {sm.mesh.size} entries")
                singles[moe] = (net0, want, net1, loss1)
            net0, want, net1, loss1 = singles[moe]
            t_mode = time.perf_counter()
            group.bind_to_thread()
            try:
                m = TorchTransformerTagger(device="cuda", **PAR_TAGGER,
                                           **extra)
                mesh = m.mesh
                check(mesh.size == PAR_ENTRIES and mesh.distinct() == 1,
                      f"{name}: mesh {mesh}")
                # (a) The logits of the fixed batch.
                with uncounted(attn), torch.no_grad():
                    got = m.logits(net0, ids, lens).float()
                tok_err = (got - want).abs().amax(-1)[real]
                err = float(tok_err.max())
                ring = (extra.get("sequence_parallel", 1) > 1
                        and extra.get("sp_schedule", "ring") == "ring")
                tol = TOL_PAR_LOGITS_LOOSE if ring else TOL_PAR_LOGITS
                allowed = PAR_FLIP_SHARE if moe else 0.0
                over = float((tok_err > tol).float().mean())
                check(over <= allowed, f"{name}: (a) logits off by more than "
                      f"{tol} at {over:.2%} of the real tokens (max "
                      f"{err:.3e}; {allowed:.0%} allowed)")
                # (b) One AdamW step from the same parameters.
                net2 = copy.deepcopy(net0)
                with uncounted(attn):
                    loss2 = par_step(torch, m, net2, ids, lens, tags)
                num = den = 0.0
                for (k, p0), p1, p2 in zip(net0.named_parameters(),
                                           net1.parameters(),
                                           net2.parameters()):
                    num += float((p2 - p1).detach().double().square().sum())
                    den += float((p1 - p0).detach().double().square().sum())
                rel = math.sqrt(num / max(den, 1e-30))
                check(abs(loss2 - loss1) <= TOL_STEP_LOSS and rel <= TOL_PAR_STEP,
                      f"{name}: (b) step loss {loss2!r} against {loss1!r}, "
                      f"parameters {rel:.3e} of the update off")
                del net2
                # (c) PAR_STEPS steps through train(), counted.
                reset_launch_counts(attn)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, epochs = logged(m.train, train_path)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                got_l = launch_counts(attn)
                per = par_launches(mesh, extra, b, n_l)
                pred = [per * PAR_STEPS] * 3
                check(list(got_l[:3]) == pred and got_l[3:] == got_l[:3],
                      f"{name}: (c) K1-K3 launched {got_l}, predicted "
                      f"{pred} all on wgmma")
                totals = [a + c for a, c in zip(totals, got_l)]
                losses = [e["loss"] for e in epochs]
                check(len(losses) == PAR_STEPS and all(
                    math.isfinite(x) for x in losses) and losses[-1]
                    < losses[0], f"{name}: (c) losses {losses}")
                # (d) Its file in a single-device tagger.
                single = TorchTransformerTagger(device="cuda",
                                                moe_experts=moe,
                                                **PAR_TAGGER)
                with uncounted(attn):
                    pm = m.predict_probs(val)
                    single.load_parameters(m.dump_parameters())
                    ps = single.predict_probs(val)
                top2 = np.sort(ps, axis=-1)[..., -2:]
                clear = (top2[..., 1] - top2[..., 0]) > PAR_NEAR_TIE
                vmask = np.zeros(pm.shape[:2], bool)
                for i, sent in enumerate(val):
                    vmask[i, :min(len(sent), t)] = True
                same = pm.argmax(-1) == ps.argmax(-1)
                ties = int((vmask & ~clear).sum())
                flips = int((~same & vmask & clear).sum())
                p_err = np.abs(pm - ps).max(-1)[vmask]
                p_over = int((p_err > TOL_PAR_PROB).sum())
                n_val = int(vmask.sum())
                check(flips <= allowed * n_val and p_over <= allowed * n_val,
                      f"{name}: (d) in a single-device tagger {flips} clear "
                      f"tags of {n_val} differ, {p_over} probabilities off "
                      f"by more than {TOL_PAR_PROB} (max "
                      f"{float(p_err.max()):.3e})")
                m.destroy()
                single.destroy()
            finally:
                ChipGroup.unbind_thread()
            mode_s = time.perf_counter() - t_mode
            shape = "x".join(f"{a}{v}" for a, v in mesh.shape.items()
                             if v > 1)
            print(f"parallel: {name} (mesh {shape}, {mesh.size} entries, "
                  f"{mesh.distinct()} card): (a) logits at real tokens max "
                  f"|diff| {err:.3e} from the single-device tagger, over "
                  f"{tol} at {over:.3%} of them; (b) one step: loss {loss2!r} against "
                  f"{loss1!r}, parameters {rel:.3e} of the update off "
                  f"(tolerance {TOL_PAR_STEP}); (c) {PAR_STEPS} steps in "
                  f"{train_s:.2f} s ({train_s / PAR_STEPS * 1e3:.1f} ms a "
                  f"step, {PAR_STEPS * b * t / train_s:.0f} tokens/s padded), "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, K1-K3 "
                  f"{list(got_l[:3])} (predicted {per} a step each), all "
                  f"wgmma; (d) its file in a single-device tagger: "
                  f"probabilities at {n_val} val tokens max |diff| "
                  f"{float(p_err.max()):.3e} (over {TOL_PAR_PROB} at "
                  f"{p_over}), {flips} clear tags differ ({ties} near ties "
                  f"not held); mode "
                  f"took {mode_s:.1f} s on {card}", flush=True)
            out["modes"][name] = {"logit_err": err, "logit_over": over,
                                  "tag_flips": flips,
                                  "prob_err": float(p_err.max()),
                                  "step_rel": rel,
                                  "loss_first": losses[0],
                                  "loss_last": losses[-1],
                                  "step_ms": train_s / PAR_STEPS * 1e3,
                                  "launches": list(got_l[:3]), "s": mode_s}
        # K1 and K2 with K3 at the Ulysses shape, on the model's own
        # q, k, v: dp rank 0's sp rank 0 after the re-chunk.
        net0 = singles[0][0]
        with torch.no_grad():
            x = net0.Embed_0(ids) + net0.pe[None, :t].to(torch.bfloat16)
            blk = net0._EncoderBlock_0
            qkv = blk.Dense_0(blk.LayerNorm_0(x)).chunk(3, dim=-1)
            h = PAR_TAGGER["n_heads"]
            q, k, v = (y.reshape(b, t, h, -1).transpose(1, 2) for y in qkv)
            dp_u, sp_u = PAR_ENTRIES // 2, 2
            bu, hu = b // dp_u, h // sp_u
            qu, ku, vu = (y[:bu, :hu].contiguous() for y in (q, k, v))
            mask = real[:bu]
        with uncounted(attn):
            kern = zoo2_kernels(torch, attn, card, "Ulysses", qu, ku, vu,
                                mask, tag="parallel:")
        # The whole Ulysses attention of one dp row (both re-chunks, the
        # copies to contiguous and K1 on each sp rank).
        tl = t // sp_u
        shards = [[y[:bu, :, j * tl:(j + 1) * tl] for j in range(sp_u)]
                  for y in (q, k, v)]
        mshards = [mask[:, j * tl:(j + 1) * tl] for j in range(sp_u)]
        with uncounted(attn), torch.no_grad():
            uly_ms = time_ms(torch, lambda: attn.ulysses_attention(
                *shards, kv_masks=mshards), 10)
        print(f"parallel: one dp row's Ulysses attention forward at the "
              f"tagger's shape ({sp_u} sequence shards of ({bu},{h},{tl},"
              f"{PAR_TAGGER['d_model'] // h})): "
              f"{uly_ms:.4f} ms (CUDA events), of which K1 on its "
              f"{sp_u} ranks {sp_u * kern['K1']['ms']:.4f} ms; the rest "
              f"the re-chunks and copies, on {card}", flush=True)
        out.update(kernels=kern, ulysses_ms=uly_ms)
    finally:
        tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= PAR_MAX_S, f"the parallel phase took {phase_s:.1f} s")
    print(f"parallel: K1, K2 and K3 launched {totals[:3]} times in the "
          f"phase's {PAR_STEPS}-step trainings, all on wgmma; mesh of "
          f"{PAR_ENTRIES} entries on 1 distinct card; phase took "
          f"{phase_s:.1f} s on {card}", flush=True)
    out.update(launches=totals[:3], phase_s=phase_s)
    return out


def f64_on_card(torch, a):
    """An array or tensor as a float64 tensor on the card."""
    import numpy as np

    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return a.to("cuda", torch.float64)


def dp_rel(torch, p0, p1, p2, keys):
    """How far ``p2`` is from ``p1`` over ``p1``'s move from ``p0``:
    ||p2 − p1|| / ||p1 − p0|| over the leaves ``keys`` of three flat
    dicts of arrays or tensors (norms on the card, in f64)."""
    num = den = 0.0
    for k in keys:
        a0, a1, a2 = (f64_on_card(torch, d[k]) for d in (p0, p1, p2))
        num += float((a2 - a1).square().sum())
        den += float((a1 - a0).square().sum())
    return math.sqrt(num / max(den, 1e-30))


def dp_flips(torch, p0, p1, p2, keys):
    """Where ``p2``'s move from ``p0`` and ``p1``'s point opposite ways:
    (the share of the elements of ``keys`` whose moves have opposite
    signs, the share of ||p2 − p1||² that those elements carry)."""
    flips = n = 0
    on_flips = total = 0.0
    for k in keys:
        a0, a1, a2 = (f64_on_card(torch, d[k]) for d in (p0, p1, p2))
        opposite = (a1 - a0) * (a2 - a0) < 0
        gap = (a2 - a1).square()
        flips += int(opposite.sum())
        n += a0.numel()
        on_flips += float(gap[opposite].sum())
        total += float(gap.sum())
    return flips / max(n, 1), on_flips / max(total, 1e-30)


def dp_records(fn, *args, **kw):
    """``fn(*args, **kw)`` with the model logger's value records kept;
    returns (result, the records' values)."""
    from rafiki_torch.model.logger import logger

    recs = []
    prior = logger.current_sink()
    logger.set_sink(recs.append)
    try:
        out = fn(*args, **kw)
    finally:
        logger.set_sink(prior)
    return out, [r["values"] for r in recs if r["type"] == "values"]


def dp_probs(np, name, a, b):
    """(max |a − b|, clear tags that differ) of two (n, classes)
    probability arrays; a tag is clear where ``b``'s two best are more
    than PAR_NEAR_TIE apart."""
    top2 = np.sort(b, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > PAR_NEAR_TIE
    flips = int(((a.argmax(-1) != b.argmax(-1)) & clear).sum())
    err = float(np.abs(a - b).max())
    check(err <= TOL_PAR_PROB and flips == 0,
          f"{name}: probabilities on the mesh max |diff| {err:.3e} from one "
          f"device (tolerance {TOL_PAR_PROB}), {flips} clear tags differ")
    return err, flips


def dp_phase(torch, np, attn, card, lm_params):
    """Data and tensor parallelism of the other families on a mesh of
    DP_ENTRIES entries, each the one card, bound to the thread as a
    worker binds its group; each against the single device on the same
    weights and data: (a) the flagship LM's step through ``train`` (K1-K3
    on every rank) and a planted fault that the tolerance must catch,
    (b) ViT over dp 2 × tp 2 (its step, probabilities, column-parallel
    layers, K1-K3 on every rank), (c) DenseNet-121's step and running
    statistics (BatchNorm over the whole batch) and an epoch captured
    over the mesh against the same epoch's eager steps, (d) the tables
    and the BiLSTM, (e) a ``TrainWorker`` given the group trains,
    persists and serves a ViT trial, held against the same trial's
    eager steps on the group and its steps on one device. Returns the
    phase's numbers and the K1-K3 launches of its main paths."""
    import os

    from rafiki_torch.advisor import make_advisor
    from rafiki_torch.bus import connect
    from rafiki_torch.constants import (ServiceStatus, ServiceType,
                                        TaskType, TrialStatus, UserType)
    from rafiki_torch.datasets import (make_synthetic_corpus_dataset,
                                       make_synthetic_image_dataset,
                                       make_synthetic_tabular_dataset,
                                       make_synthetic_token_dataset)
    from rafiki_torch.model import torch_model
    from rafiki_torch.model.bridge import dense_to_jax, lm_from_jax
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import (TorchDenseNet, TorchPosTagger,
                                     TorchTabMlpClf, TorchTransformerLM,
                                     TorchViT, layers)
    from rafiki_torch.models import lm as lm_module
    from rafiki_torch.parallel.chips import ChipGroup
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.utils.model_loader import load_model_class
    from rafiki_torch.worker.inference import InferenceWorker
    from rafiki_torch.worker.train import TrainWorker

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    group = ChipGroup(indices=(0,) * DP_ENTRIES)
    out = {}
    totals = [0] * 6

    def on_group(fn, *args, **kw):
        group.bind_to_thread()
        try:
            return fn(*args, **kw)
        finally:
            ChipGroup.unbind_thread()

    def synced(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def counted(fn, *args, **kw):
        """A main path: ``fn``'s result, its seconds and its K1-K3
        launches (counted from 0), added to the phase's."""
        nonlocal totals
        reset_launch_counts(attn)
        res, secs = synced(fn, *args, **kw)
        got = launch_counts(attn)
        totals = [a + c for a, c in zip(totals, got)]
        return res, secs, got

    def checked(fn, *args, **kw):
        """A run to compare with: ``fn``'s result and its seconds; its
        launches are not the main path's."""
        with uncounted(attn):
            return synced(fn, *args, **kw)

    def mesh_of(m, dp, tp=1):
        mesh = m.mesh
        check(mesh.size == DP_ENTRIES and mesh.distinct() == 1
              and (mesh.shape["dp"], mesh.shape["tp"]) == (dp, tp),
              f"mesh {mesh}: expected dp {dp} x tp {tp} on one card")
        return mesh

    def free(*models):
        for m in models:
            m.destroy()
        torch.cuda.empty_cache()

    @contextlib.contextmanager
    def step_log():
        """While open, each ``_TrainSteps`` step's (kind: eager, capture
        or replay; seconds; loss, read off the step's device sums)."""
        log = []
        real = torch_model._TrainSteps.step

        def step(self):
            kind = ("replay" if self.graph is not None else "eager"
                    if self.n_eager < torch_model.WARMUP_STEPS else
                    "capture")
            torch.cuda.synchronize()
            before = float(self.sums[0])
            t = time.perf_counter()
            real(self)
            torch.cuda.synchronize()
            log.append((kind, time.perf_counter() - t,
                        float(self.sums[0]) - before))

        torch_model._TrainSteps.step = step
        try:
            yield log
        finally:
            torch_model._TrainSteps.step = real

    @contextlib.contextmanager
    def warmup_steps(n):
        """``n`` eager steps before the capture (10**9: every step)."""
        saved = torch_model.WARMUP_STEPS
        torch_model.WARMUP_STEPS = n
        try:
            yield
        finally:
            torch_model.WARMUP_STEPS = saved

    def graph_check(name, steps, eager):
        """The largest gap of two step logs' per-step losses; fails
        unless ``steps`` are WARMUP_STEPS eager ones, the capture and
        replays, and ``eager`` as many eager steps."""
        w = torch_model.WARMUP_STEPS
        kinds = [k for k, _, _ in steps]
        check(kinds == ["eager"] * w + ["capture"]
              + ["replay"] * (len(kinds) - w - 1) and len(kinds) > w + 1
              and [k for k, _, _ in eager] == ["eager"] * len(kinds),
              f"{name}: steps {kinds} against {[k for k, _, _ in eager]}")
        return max(abs(a[2] - b[2]) for a, b in zip(steps, eager))

    try:
        # (a) The flagship LM: one step through train, batch 8 over dp 4.
        t0 = time.perf_counter()
        # Two steps (the warm-up cosine needs a step past its one
        # warm-up step), one record each.
        knobs = dict(TorchTransformerLM.validate_knobs(FLAGSHIP),
                     train_steps=2, steps_per_dispatch=1)
        n_l = knobs["n_layers"]
        lm_path, _ = make_synthetic_token_dataset(
            os.path.join(tmp.name, "lm"), n_train=DP_LM_IDS, n_val=1 << 12,
            vocab_size=knobs["vocab_size"], seed=SEED)

        def lm_step():
            m = TorchTransformerLM(device="cuda", **knobs)
            m.load_parameters(lm_params)
            _, recs = dp_records(m.train, lm_path)
            return m, recs

        def weights(m):
            return {k: v.detach().clone()
                    for k, v in m._net.state_dict().items()}

        (m1, rec1), s1 = checked(lm_step)
        p1 = weights(m1)
        free(m1)
        (m4, rec4), s4, got = on_group(counted, lm_step)
        dp = mesh_of(m4, DP_ENTRIES).shape["dp"]
        p4 = weights(m4)
        free(m4)
        # The planted fault: a rank's windows repeated.
        real_blocks = lm_module.row_blocks
        lm_module.row_blocks = lambda n, parts: list(DP_FAULT_BLOCKS)
        try:
            (mf, _), _ = on_group(checked, lm_step)
        finally:
            lm_module.row_blocks = real_blocks
        pf = weights(mf)
        free(mf)
        loss1 = [r["loss"] for r in rec1]
        loss4 = [r["loss"] for r in rec4]
        p0 = lm_from_jax(lm_params)
        rel = dp_rel(torch, p0, p1, p4, list(p1))
        rel_fault = dp_rel(torch, p0, p1, pf, list(p1))
        flip_share, flip_gap = dp_flips(torch, p0, p1, p4, list(p1))
        pred = [2 * 2 * n_l * dp, 2 * n_l * dp, 2 * n_l * dp]
        check(len(loss4) == len(loss1) == 2 and all(
            abs(a - b) <= TOL_STEP_LOSS for a, b in zip(loss4, loss1))
            and rel <= TOL_PAR_STEP,
            f"(a) the LM's steps over dp {dp}: losses {loss4} against "
            f"{loss1}, parameters {rel:.3e} of the update off")
        check(rel_fault > TOL_PAR_STEP,
              f"(a) with a rank's windows repeated the parameters are "
              f"{rel_fault:.3e} of the update off, within {TOL_PAR_STEP}")
        check(list(got[:3]) == pred and got[3:] == got[:3],
              f"(a) K1-K3 launched {got}, predicted {pred} all on wgmma")
        del p0, p1, p4, pf
        torch.cuda.empty_cache()
        print(f"dp: (a) the flagship LM (d_model 2048, 16 heads of 128, "
              f"{n_l} layers, seq_len 2048, batch 8 over dp {dp}: 2 "
              f"windows a rank) from the train phase's parameters, two "
              f"steps through train: losses {loss4} against the single "
              f"device's {loss1}; parameters {rel:.3e} of the update off "
              f"(tolerance {TOL_PAR_STEP}), of which {flip_gap:.1%} of "
              f"the squared gap on the {flip_share:.4%} of the elements "
              f"that moved the other way; with the 4th rank taking the "
              f"3rd rank's windows again (a planted fault) {rel_fault:.3e}; "
              f"K1-K3 {list(got[:3])} = 2 "
              f"steps x (2 x {n_l} layers, {n_l}, {n_l}) x {dp} ranks, all "
              f"wgmma (remat 'dots' reruns K1); the train call "
              f"{s4:.3f} s on the mesh, {s1:.3f} s on one device (the "
              f"optimizer's state made in the first step); (a) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["lm"] = {"loss": loss4, "loss_single": loss1, "step_rel": rel,
                     "fault_rel": rel_fault, "flip_share": flip_share,
                     "flip_gap_share": flip_gap,
                     "step_s": s4, "step_s_single": s1,
                     "launches": list(got[:3])}

        # (b) ViT at zoo2 (a)'s widths over dp 2 x tp 2.
        t0 = time.perf_counter()
        vit_train, vit_val = make_synthetic_image_dataset(
            os.path.join(tmp.name, "vit"), n_train=DP_VIT_TRAIN,
            n_val=DP_VIT_VAL, image_shape=(32, 32, 3), n_classes=10,
            seed=SEED)
        vk = dict(ZOO2_VIT)
        depth = vk["depth"]
        net0 = TorchViT(device="cuda", **vk).create_module(10, (32, 32, 3))
        start = dense_to_jax(net0.state_dict())
        meta = {"_meta/n_classes": np.asarray(10),
                "_meta/image_shape": np.asarray([32, 32, 3])}
        images = load_image_dataset(vit_val).images
        columns = []
        real_column = layers.column

        def column(layer, x, fn, dim=-1):
            if getattr(layer, "tp_shards", None) is not None:
                columns.append(len(layer.tp_shards))
            return real_column(layer, x, fn, dim)

        def vit(**extra):
            m = TorchViT(device="cuda", **vk, **extra)
            _, epochs = logged(m.train, vit_train, shared_params=start)
            return m, epochs

        (v1, e1), vs1 = checked(vit)
        ms = TorchViT(device="cuda", **vk)
        ms.load_parameters({**start, **meta})
        probs1, _ = checked(ms.predict_proba, images)
        layers.column = column
        try:
            (v4, e4), vs4, got = on_group(counted, vit, tensor_parallel=2)

            def mesh_probs():
                mm = TorchViT(device="cuda", tensor_parallel=2, **vk)
                mm.load_parameters({**start, **meta})
                return mm, checked(mm.predict_proba, images)[0]

            mm, probs4 = on_group(mesh_probs)
        finally:
            layers.column = real_column
        dp = mesh_of(v4, 2, 2).shape["dp"]
        mesh_of(mm, 2, 2)
        rel = dp_rel(torch, start, v1.dump_parameters(), v4.dump_parameters(),
                     list(start))
        pred = [depth * (1 + dp), depth * dp, depth * dp]
        check(abs(e4[0]["loss"] - e1[0]["loss"]) <= TOL_STEP_LOSS
              and rel <= TOL_PAR_STEP,
              f"(b) ViT's step over dp 2 x tp 2: loss {e4[0]['loss']!r} "
              f"against {e1[0]['loss']!r}, parameters {rel:.3e} of the "
              f"update off")
        check(list(got[:3]) == pred and got[3:] == got[:3],
              f"(b) K1-K3 launched {got}, predicted {pred} all on wgmma")
        check(columns and set(columns) == {2},
              f"(b) column-parallel calls {len(columns)} over "
              f"{set(columns)} tp ranks")
        p_err, _ = dp_probs(np, "(b) ViT", probs4, probs1)
        free(v1, v4, ms, mm)
        print(f"dp: (b) ViT (d_model 128, 4 heads of 32, patch 4, 6 "
              f"blocks, batch 256 over dp 2 x tp 2) from the same "
              f"parameters: one step's loss {e4[0]['loss']!r} against "
              f"{e1[0]['loss']!r}, parameters {rel:.3e} of the update off; "
              f"{len(columns)} column-parallel layer calls over 2 tp ranks "
              f"(each block's QKV and first FFN kernels); K1-K3 "
              f"{list(got[:3])} (K1 {depth} in the MFU probe's one-image "
              f"forward, then {depth} blocks x {dp} dp ranks each), all "
              f"wgmma; probabilities of {len(images)} images max |diff| "
              f"{p_err:.3e} from one device; the step's train call "
              f"{vs4:.3f} s on the mesh, {vs1:.3f} s on one device; (b) "
              f"took {time.perf_counter() - t0:.1f} s", flush=True)
        out["vit"] = {"loss": e4[0]["loss"], "loss_single": e1[0]["loss"],
                      "step_rel": rel, "prob_err": p_err,
                      "columns": len(columns), "launches": list(got[:3]),
                      "step_s": vs4, "step_s_single": vs1}

        # (c) DenseNet-121 over dp 4: one step, then a 4-step epoch.
        t0 = time.perf_counter()
        dk = dict(DENSENET_KNOBS)
        bsz = dk["batch_size"]
        dn1, _ = make_synthetic_image_dataset(
            os.path.join(tmp.name, "dn1"), n_train=bsz, n_val=16,
            image_shape=(32, 32, 3), n_classes=10, seed=SEED)
        dn4, _ = make_synthetic_image_dataset(
            os.path.join(tmp.name, "dn4"), n_train=bsz * DP_DENSE_STEPS,
            n_val=16, image_shape=(32, 32, 3), n_classes=10, seed=SEED + 1)
        start = dense_to_jax(TorchDenseNet(device="cuda", **dk).create_module(
            10, (32, 32, 3)).state_dict())

        def dense(path, **kw):
            m = TorchDenseNet(device="cuda", **dk)
            _, epochs = logged(m.train, path, shared_params=start, **kw)
            return m, epochs

        sk = dict(dk, arch=DP_DENSE_CAPTURE)
        small_start = dense_to_jax(TorchDenseNet(
            device="cuda", **sk).create_module(10, (32, 32, 3)).state_dict())

        def small(path, warmup):
            m = TorchDenseNet(device="cuda", **sk)
            with warmup_steps(warmup):
                _, epochs = logged(m.train, path, shared_params=small_start)
            return m, epochs

        # One step: its warm-up cosine spans two epochs' steps (one step
        # cannot hold both its warm-up and its decay).
        one = {"schedule_total_epochs": 2}

        saved = (layers.COMPUTE, torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        layers.COMPUTE = torch.float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            (d1, de1), ds1 = checked(dense, dn1, **one)
            (d4, de4), ds4, _ = on_group(counted, dense, dn1, **one)
        finally:
            (layers.COMPUTE, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        mesh_of(d4, DP_ENTRIES)
        q1, q4 = d1.dump_parameters(), d4.dump_parameters()
        stats = [k for k in start if k.startswith("batch_stats/")]
        weights = [k for k in start if k.startswith("params/")]
        rel_stats = dp_rel(torch, start, q1, q4, stats)
        rel = dp_rel(torch, start, q1, q4, weights)
        free(d1, d4)
        check(abs(de4[0]["loss"] - de1[0]["loss"]) <= TOL_STEP_LOSS
              and rel <= TOL_DP_F32_STEP and rel_stats <= TOL_DP_STATS,
              f"(c) DenseNet-121's step over dp 4: loss {de4[0]['loss']!r} "
              f"against {de1[0]['loss']!r}, parameters {rel:.3e} and "
              f"running statistics {rel_stats:.3e} of their move off")
        # The epoch captured over the mesh against every step eager.
        with step_log() as eager_steps:
            (de, _), ees = on_group(checked, small, dn4, 10 ** 9)
        with step_log() as stepped:
            (d4, de4b), es4, _ = on_group(counted, small, dn4,
                                          torch_model.WARMUP_STEPS)
        pe, pc = de.dump_parameters(), d4.dump_parameters()
        free(de, d4)
        graph_loss = graph_check(f"(c) the {DP_DENSE_STEPS}-step epoch",
                                 stepped, eager_steps)
        graph_rel = dp_rel(torch, small_start, pe, pc, [
            k for k in small_start if k.startswith("params/")])
        graph_stats = dp_rel(torch, small_start, pe, pc, [
            k for k in small_start if k.startswith("batch_stats/")])
        check(graph_loss <= TOL_STEP_LOSS and graph_rel <= TOL_PAR_STEP
              and graph_stats <= TOL_PAR_STEP,
              f"(c) the captured epoch over dp 4 against its eager steps: "
              f"losses {graph_loss:.3e} apart, parameters {graph_rel:.3e} "
              f"and running statistics {graph_stats:.3e} of their move off")
        print(f"dp: (c) DenseNet-121 (growth 32, batch 128 over dp 4: 32 "
              f"images a rank) from the same parameters, one step in "
              f"float32 without TF32: loss {de4[0]['loss']!r} against "
              f"{de1[0]['loss']!r}; parameters {rel:.3e} of the update "
              f"off (tolerance {TOL_DP_F32_STEP}); "
              f"the 120 BatchNorms' running statistics {rel_stats:.3e} of "
              f"their move off (tolerance {TOL_DP_STATS}; each rank "
              f"normalises by the whole batch's moments); the step's train "
              f"call {ds4:.3f} s on the mesh (4 ranks in lockstep threads), "
              f"{ds1:.3f} s on one device; a {DP_DENSE_STEPS}-step bf16 "
              f"epoch of {DP_DENSE_CAPTURE} (blocks 4/4/4, growth 32) over "
              f"dp 4 in {es4:.3f} s, its steps "
              + ", ".join(f"{k} {t:.3f} s" for k, t, _ in stepped) +
              f" (the capture's first replay included; the graph covers "
              f"the 4 lockstep ranks), loss {de4b[0]['loss']:.4f}, against "
              f"the same epoch with every step eager ({ees:.3f} s): "
              f"per-step losses at most {graph_loss:.3e} apart, parameters "
              f"{graph_rel:.3e} and running statistics {graph_stats:.3e} of "
              f"their move off (tolerances {TOL_STEP_LOSS}, "
              f"{TOL_PAR_STEP}); (c) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["densenet"] = {"loss": de4[0]["loss"],
                           "loss_single": de1[0]["loss"], "step_rel": rel,
                           "stats_rel": rel_stats, "step_s": ds4,
                           "step_s_single": ds1, "epoch_s": es4,
                           "epoch_s_eager": ees, "steps": stepped,
                           "graph_loss_gap": graph_loss,
                           "graph_rel": graph_rel,
                           "graph_stats_rel": graph_stats}

        # (d) The tables and the BiLSTM over dp 4, one epoch each.
        t0 = time.perf_counter()
        tab, _ = make_synthetic_tabular_dataset(
            os.path.join(tmp.name, "tab"), n_classes=2, seed=SEED,
            **DP_TABLE)
        cor, _ = make_synthetic_corpus_dataset(
            os.path.join(tmp.name, "pos"), seed=SEED, **DP_CORPUS)
        rows = {}
        for name, cls, path, kn in (
                ("tables", TorchTabMlpClf, tab, ZOO2_TAB_KNOBS),
                ("BiLSTM", TorchPosTagger, cor, ZOO2_POS_KNOBS)):
            def fam(epochs, kn=kn, cls=cls, path=path):
                m = cls(device="cuda", **dict(kn, max_epochs=epochs))
                _, recs = logged(m.train, path)
                return m, recs

            (f0, _), _ = checked(fam, 0)
            (f1, r1), fs1 = checked(fam, 1)
            (f4, r4), fs4, got = on_group(counted, fam, 1)
            mesh_of(f4, DP_ENTRIES)
            a0, a1, a4 = (f.dump_parameters() for f in (f0, f1, f4))
            keys = [k for k in a0 if not k.startswith("_meta/")]
            rel = dp_rel(torch, a0, a1, a4, keys)
            check(abs(r4[0]["loss"] - r1[0]["loss"]) <= TOL_STEP_LOSS
                  and rel <= TOL_PAR_STEP and got[:3] == (0, 0, 0),
                  f"(d) {name} over dp 4: loss {r4[0]['loss']!r} against "
                  f"{r1[0]['loss']!r}, parameters {rel:.3e} of the update "
                  f"off, K1-K3 {got[:3]}")
            rows[name] = {"loss": r4[0]["loss"], "loss_single": r1[0]["loss"],
                          "epoch_rel": rel, "epoch_s": fs4,
                          "epoch_s_single": fs1}
            free(f0, f1, f4)
        print("dp: (d) " + "; ".join(
            f"{n} ({'batch 128' if n == 'tables' else 'batch 64'} over dp "
            f"4) one epoch from the same seeded parameters: loss "
            f"{r['loss']!r} against {r['loss_single']!r}, parameters "
            f"{r['epoch_rel']:.3e} of the update off, {r['epoch_s']:.3f} s "
            f"on the mesh and {r['epoch_s_single']:.3f} s on one device"
            for n, r in rows.items()) + f"; (d) took "
            f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update(rows)

        # (e) A TrainWorker given the 4-entry group: a ViT trial trained,
        # persisted and served.
        t0 = time.perf_counter()
        tr, va = make_synthetic_image_dataset(
            os.path.join(tmp.name, "trial"), n_train=DP_TRIAL_TRAIN,
            n_val=DP_TRIAL_VAL, image_shape=(32, 32, 3), n_classes=10,
            seed=SEED + 2)
        ms_ = MetaStore(os.path.join(tmp.name, "e.db"))
        ps_ = ParamStore(os.path.join(tmp.name, "e-params"))
        u = ms_.create_user("dp@example.com", "-", UserType.MODEL_DEVELOPER)
        row = ms_.create_model(u["id"], "vit", TaskType.IMAGE_CLASSIFICATION,
                               "DpViT", {}, model_source=DP_VIT_SOURCE)
        job = ms_.create_train_job(u["id"], "dp",
                                   TaskType.IMAGE_CLASSIFICATION,
                                   {"MODEL_TRIAL_COUNT": 1}, tr, va,
                                   status="RUNNING")
        sub = ms_.create_sub_train_job(job["id"], row["id"],
                                       status="RUNNING")
        svc = ms_.create_service(ServiceType.TRAIN, ServiceStatus.STARTED)
        cls = load_model_class("DpViT", DP_VIT_SOURCE)
        adv = make_advisor(cls.get_knob_config(), seed=SEED,
                           advisor_type="random")
        worker = TrainWorker(svc["id"], sub["id"], ms_, ps_, connect(""),
                             chips=group, advisor=adv)

        def trial():
            worker.start()
            worker.join(SEARCH_WAIT_S)

        with step_log() as trial_steps:
            _, ts, got = counted(trial)
        done = ms_.get_trials(sub["id"], status=TrialStatus.COMPLETED)
        check(not worker.running and len(done) == 1,
              f"(e) the worker's trials {len(done)}")
        steps = DP_TRIAL_TRAIN // 256
        evals = -(-DP_TRIAL_VAL // torch_model.EVAL_BATCH)
        per = depth * DP_ENTRIES
        pred = [depth + (torch_model.WARMUP_STEPS + 1 + evals) * per,
                (torch_model.WARMUP_STEPS + 1) * per,
                (torch_model.WARMUP_STEPS + 1) * per]
        check(steps > torch_model.WARMUP_STEPS and list(got[:3]) == pred
              and got[3:] == got[:3],
              f"(e) K1-K3 launched {got}, predicted {pred} all on wgmma")
        params = ps_.load(done[0]["params_id"])
        # The same trial again: on one device, and on the group with
        # every step eager.
        tk = cls.validate_knobs(done[0]["knobs"])
        trial_start = dense_to_jax(cls(device="cuda", **tk).create_module(
            10, (32, 32, 3)).state_dict())

        def again(warmup):
            m = cls(device="cuda", **tk)
            with warmup_steps(warmup):
                m.train(tr)
            p = m.dump_parameters()
            free(m)
            return p

        with step_log() as one_steps:
            one_p, _ = checked(again, torch_model.WARMUP_STEPS)
        with step_log() as eager_steps:
            eager_p, _ = on_group(checked, again, 10 ** 9)
        keys = list(trial_start)
        graph_loss = graph_check("(e) the trial", trial_steps, eager_steps)
        one_loss = max(abs(a[2] - b[2]) for a, b in zip(trial_steps,
                                                        one_steps))
        graph_rel = dp_rel(torch, trial_start, eager_p, params, keys)
        one_rel = dp_rel(torch, trial_start, one_p, params, keys)
        check(len(one_steps) == len(trial_steps)
              and max(graph_loss, one_loss) <= TOL_STEP_LOSS
              and max(graph_rel, one_rel) <= TOL_PAR_STEP,
              f"(e) the trial's {len(trial_steps)} steps over the group: "
              f"losses {graph_loss:.3e} from its eager steps and "
              f"{one_loss:.3e} from one device's, parameters "
              f"{graph_rel:.3e} and {one_rel:.3e} of their move off")

        def serving():
            w = InferenceWorker(cls, done[0]["knobs"], params,
                                device="cuda")
            # Built from the group bound here, as a serving worker binds
            # its group on its thread.
            check(w.model.mesh.size == DP_ENTRIES,
                  f"(e) the serving model's mesh {w.model.mesh}")
            return w

        served_w = on_group(serving)
        queries = list(load_image_dataset(va).images[:64])
        served_w.start()
        try:
            served = np.asarray(checked(served_w.predict, queries)[0])
        finally:
            served_w.stop()
        single = cls(device="cuda", **cls.validate_knobs(done[0]["knobs"]))
        single.load_parameters(params)
        own = np.asarray(checked(single.predict, queries)[0])
        e_err, _ = dp_probs(np, "(e) the served trial", served, own)
        ps_.close()
        ms_.close()
        print(f"dp: (e) a TrainWorker given ChipGroup(indices=(0,) * "
              f"{DP_ENTRIES}) trained one ViT trial (knobs "
              f"{ {k: done[0]['knobs'][k] for k in ('learning_rate', 'batch_size')} }, "
              f"score {done[0]['score']:.4f}) over dp {DP_ENTRIES} in "
              f"{ts:.2f} s and persisted it; K1-K3 {list(got[:3])} "
              f"(predicted: the MFU probe's {depth}, then {steps} steps of "
              f"which {torch_model.WARMUP_STEPS} eager and the capture "
              f"count {per} each, the replays none, and the evaluation's "
              f"{evals} batch {per} K1), all wgmma; against the same trial "
              f"with every step eager on the group and on one device: "
              f"per-step losses at most {graph_loss:.3e} and {one_loss:.3e} "
              f"apart, parameters {graph_rel:.3e} and {one_rel:.3e} of "
              f"their move off (tolerances {TOL_STEP_LOSS}, "
              f"{TOL_PAR_STEP}); served by an "
              f"InferenceWorker on the group (dp {DP_ENTRIES} buckets): "
              f"{len(queries)} answers max |diff| {e_err:.3e} from a "
              f"single-device load of its parameters; (e) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["trial"] = {"seconds": ts, "prob_err": e_err,
                        "launches": list(got[:3]),
                        "graph_loss_gap": graph_loss,
                        "single_loss_gap": one_loss,
                        "graph_rel": graph_rel, "single_rel": one_rel}
    finally:
        tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= DP_MAX_S, f"the dp phase took {phase_s:.1f} s")
    print(f"dp: K1, K2 and K3 launched {totals[:3]} times on the phase's "
          f"main paths, all on wgmma; mesh of {DP_ENTRIES} entries on 1 "
          f"distinct card; phase took {phase_s:.1f} s on {card}", flush=True)
    out.update(launches=totals[:3], phase_s=phase_s)
    return out


def zoo2_rows(zoo2, kernel):
    """One kernel's numbers at the zoo2 phase's ViT and tagger shapes."""
    return {what: dict(zoo2[part]["kernels"][kernel],
                       shape=zoo2[part]["kernels"]["shape"],
                       mask=zoo2[part]["kernels"]["mask"])
            for what, part in (("vit", "vit"), ("tagger", "tagger"))}


def data_row(data, kernel):
    """One kernel's numbers at the real corpus's tagger shape."""
    return dict(data["kernels"][kernel], shape=data["kernels"]["shape"],
                mask=data["kernels"]["mask"])


def analysis_phase():
    """The port's static-analysis suite over this checkout: exit 0 and
    no new finding."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "rafiki_torch.analysis", "--json",
         "--root", root], cwd=root, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"rafiki_torch.analysis exited "
          f"{out.returncode}: {out.stdout[-2000:]}{out.stderr[-2000:]}")
    report = json.loads(out.stdout)
    check(report["new"] == 0, f"{report['new']} new analysis findings")
    counts = {c: n for c, n in report["counts_per_code"].items() if n}
    print(f"analysis: {report['files']} files, {sum(counts.values())} "
          f"findings by code {counts}, by status {report['by_status']}, "
          f"new {report['new']}, {secs:.1f} s", flush=True)


def timed(name, fn, *args):
    """``fn(*args)``, printing the phase's own seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phases: {name} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # A crash in native code (CUDA, CUPTI, a kernel's host side)
    # prints every thread's Python stack to stderr before the process
    # dies, so the phase and call that crashed are on record.
    faulthandler.enable(all_threads=True)
    try:
        from rafiki_torch.ops import _build
        from rafiki_torch.ops import attention as attn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(card, flush=True)
        timed("analysis", analysis_phase)
        secs = _build.build_all()
        print(f"build: kernels built in {secs:.1f} s", flush=True)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            log = _build.build_log(name)
            print(f"build: {name}.cu: {ptxas_summary(log)}", flush=True)
            for line in build_warnings(log):
                print(f"build: {name}.cu: {line}", flush=True)
        f32_regs = {name: k for name, k in ptxas_kernels(
            _build.build_log("flash_fwd")).items() if "f32" in name}
        print("build: K1's f32 variant: " + "; ".join(
            f"{name}: {k['registers']} registers, {k['spill_bytes']} spill "
            f"bytes" for name, k in f32_regs.items()), flush=True)
        k1 = timed("kernel", kernel_phase, torch, attn)
        k1_train, k2, k3 = timed("backward", backward_phase, torch, attn)
        params, train_launches = timed("train", train_phase, torch, np,
                                       attn, card)
        serve_launches = timed("serve", slice_phase, torch, np, attn, card,
                               params)
        gen_launches, gen = timed("generate", generate_phase, torch, np,
                                  attn, card, params)
        automl = timed("automl", automl_phase, torch, np, attn, card)
        _, plat_launches = timed("platform", platform_phase, torch, np,
                                 attn, card, automl)
        # The zoo phase's image set is made once: zoo2 and the tenants
        # phase's ViT job train on it too.
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data:
            zoo = timed("zoo", zoo_phase, torch, np, attn, card, data)
            ens = timed("ensemble", ensemble_phase, torch, np, attn, card,
                        automl, zoo)
            zoo2 = timed("zoo2", zoo2_phase, torch, np, attn, card,
                         zoo["data"])
            life = timed("lifecycle", lifecycle_phase, torch, np, attn,
                         card, zoo2)
            ten = timed("tenants", tenants_phase, torch, np, attn, card,
                        zoo["data"])
        procs = timed("processes", processes_phase, torch, np, attn, card)
        clus = timed("cluster", cluster_phase, torch, np, attn, card, zoo2)
        scale = timed("autoscale", autoscale_phase, torch, np, attn, card,
                      zoo2)
        oper = timed("operator", operator_phase, torch, np, attn, card,
                     zoo2)
        search = timed("search", search_phase, torch, np, attn, card, zoo2)
        data = timed("data", data_phase, torch, np, attn, card, zoo2,
                     params)
        par = timed("parallel", parallel_phase, torch, np, attn, card)
        dp = timed("dp", dp_phase, torch, np, attn, card, params)
    except Exception:
        traceback.print_exc()
        return 1
    src = "rafiki_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        dict(name="flash_fwd (K1)", route="cuda", source=src + "flash_fwd.cu",
             replaces="rafiki_tpu/ops/attention.py:162",
             launches=(train_launches[0] + serve_launches + gen_launches
                       + plat_launches[0] + zoo2["launches"][0]
                       + life["launches"][0] + ten["launches"][0]
                       + procs["launches"][0] + clus["launches"][0]
                       + scale["launches"][0] + oper["launches"][0]
                       + search["launches"][0] + data["launches"][0]
                       + par["launches"][0] + dp["launches"][0]),
             generate_launches=gen_launches,
             platform_launches=plat_launches[0],
             zoo_launches=zoo["launches"][0],
             ensemble_launches=ens["launches"][0],
             zoo2_launches=zoo2["launches"][0],
             lifecycle_launches=life["launches"][0],
             tenants_launches=ten["launches"][0],
             processes_launches=procs["launches"][0],
             processes_trace_events=procs["trace_events"][0],
             cluster_launches=clus["launches"][0],
             autoscale_launches=scale["launches"][0],
             operator_launches=oper["launches"][0],
             search_launches=search["launches"][0],
             data_launches=data["launches"][0],
             parallel_launches=par["launches"][0],
             dp_launches=dp["launches"][0],
             parallel_shape=data_row(par, "K1"),
             zoo2_shapes=zoo2_rows(zoo2, "K1"),
             data_shape=data_row(data, "K1"),
             zoo2_f32=dict(zoo2["int8"]["k1_f32"], registers=f32_regs),
             generate_buckets=gen["buckets"], **k1, **k1_train),
        dict(name="flash_bwd_dq (K2)", route="cuda",
             source=src + "flash_bwd_dq.cu",
             replaces="rafiki_tpu/ops/attention.py:338",
             launches=(train_launches[1] + plat_launches[1]
                       + zoo2["launches"][1] + life["launches"][1]
                       + ten["launches"][1] + procs["launches"][1]
                       + clus["launches"][1] + scale["launches"][1]
                       + oper["launches"][1] + search["launches"][1]
                       + data["launches"][1] + par["launches"][1]
                       + dp["launches"][1]),
             platform_launches=plat_launches[1],
             zoo_launches=zoo["launches"][1],
             ensemble_launches=ens["launches"][1],
             zoo2_launches=zoo2["launches"][1],
             lifecycle_launches=life["launches"][1],
             tenants_launches=ten["launches"][1],
             processes_launches=procs["launches"][1],
             processes_trace_events=procs["trace_events"][1],
             cluster_launches=clus["launches"][1],
             autoscale_launches=scale["launches"][1],
             operator_launches=oper["launches"][1],
             search_launches=search["launches"][1],
             data_launches=data["launches"][1],
             parallel_launches=par["launches"][1],
             dp_launches=dp["launches"][1],
             parallel_shape=data_row(par, "K2"),
             zoo2_shapes=zoo2_rows(zoo2, "K2"),
             data_shape=data_row(data, "K2"), **k2),
        dict(name="flash_bwd_dkv (K3)", route="cuda",
             source=src + "flash_bwd_dkv.cu",
             replaces="rafiki_tpu/ops/attention.py:401",
             launches=(train_launches[2] + plat_launches[2]
                       + zoo2["launches"][2] + life["launches"][2]
                       + ten["launches"][2] + procs["launches"][2]
                       + clus["launches"][2] + scale["launches"][2]
                       + oper["launches"][2] + search["launches"][2]
                       + data["launches"][2] + par["launches"][2]
                       + dp["launches"][2]),
             platform_launches=plat_launches[2],
             zoo_launches=zoo["launches"][2],
             ensemble_launches=ens["launches"][2],
             zoo2_launches=zoo2["launches"][2],
             lifecycle_launches=life["launches"][2],
             tenants_launches=ten["launches"][2],
             processes_launches=procs["launches"][2],
             processes_trace_events=procs["trace_events"][2],
             cluster_launches=clus["launches"][2],
             autoscale_launches=scale["launches"][2],
             operator_launches=oper["launches"][2],
             search_launches=search["launches"][2],
             data_launches=data["launches"][2],
             parallel_launches=par["launches"][2],
             dp_launches=dp["launches"][2],
             parallel_shape=data_row(par, "K3"),
             zoo2_shapes=zoo2_rows(zoo2, "K3"),
             data_shape=data_row(data, "K3"), **k3)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
