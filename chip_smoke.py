#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version at its path's real shapes, serve a few requests
through the continuous-batching replica at Mixtral-8x7B's published widths
(8 of its 32 layers), train the dense Llama-2-7B (8 of its 32 layers) and
the Mixtral-8x7B-width MoE (2 of its 32 layers) for a few steps, kill and
resume a Llama-2-7B-width run from its checkpoint, train the vision TFJobs
(ResNet-50 at its published widths, the Flax-MNIST CNN), run ring and
Ulysses attention at T 32768 over virtual ranks, generate from a KV cache
at Mixtral-8x7B widths and on Llama-2-7B at all 32 layers, run each rank
of a (pp 2, sp 2) pipeline alone, train as the one pod of a TPU-typed job
through the pod's launcher on the card the port's inventory binds, and
check what comes out.

    python3 chip_smoke.py [--seed N]     # one card

Phases, in order (any failure raises and exits non-zero):

1. build: ``nvcc`` compiles ``kubeflow_controller_tpu_torch/csrc/*.cu`` for
   sm_90a, one process per source, all at once, through
   ``compile_cache.build_kernels`` under a file-drop progress reporter
   that also records its beats: the window beats ``{"phase": "compile"}``
   (the dropped file reads it after), and the source returned is
   "compiled" (the library was absent before) or "cache-hit" (it was
   there); prints the build seconds,
   ptxas' warnings and "performance loss" notes (wgmma serialized), and
   each kernel's registers and spill bytes (no kernel may spill; the
   swap-AB decode kernels' on a line of their own).  Then ``cuobjdump
   -sass`` of the library: the HGMMA (wgmma) instructions of each kernel
   instantiation, nonzero in every ``gmm_wgmma_kernel``,
   ``gmm_swiglu_wgmma_kernel`` and ``tgmm_wgmma_kernel`` (the bm >= 64
   design), in every ``gmm_swapab_kernel`` (``gmm`` and ``gmm_swiglu`` at
   bm < 64) and in the three flash kernels (``flash_fwd_wgmma_kernel``,
   ``flash_dq_wgmma_kernel``, ``flash_dkv_wgmma_kernel``), zero in the
   WMMA ``tgmm_kernel`` (bm < 64).
2. gmm kernels: ``gmm_swiglu`` and ``gmm`` at the decode layout (8 slots x
   top-2 = 16 routed rows, M = 144, bm = 16: swap-AB), decode layouts
   with expert E - 1 routed and unrouted (then its weights are read only
   for the clamped tail tiles), the 16-token prefill bucket (32 rows, M =
   288, bm = 32: swap-AB) and the 128-token prefill bucket (256 rows, M =
   2304, bm = 256: wgmma), bf16, against the plain versions computed in
   f32 on the same inputs.  Only the rows the combine reads are compared
   (tiles past the last group hold garbage in the reference too).
   Tolerance: max |kernel - plain| <= 2e-2 * max |plain| (bf16 output,
   one rounding).
   Prints each kernel's ms, the plain version's ms, a per-expert
   ``torch.matmul`` loop's ms (``library_ms``, a yardstick the port never
   calls), the bound (bytes over the touched experts, or FLOPs) and the
   bytes/s it reached over the touched experts.  Then ragged shapes (K
   200, N 328: multiples of 8, not of the wgmma tiles) at bm 64 and 128
   (wgmma) and 4, 8, 16 and 32 (swap-AB; ``tgmm`` WMMA): ``gmm_swiglu``
   writing h, gate and up; ``gmm`` with rhs [E, K, N] and [E, N, K], with
   and without ``valid_tiles``; every row within 2e-2 of max, skipped rows
   exactly 0; ``tgmm`` per expert as in phase 3, its tile-short control,
   the unrouted expert exactly 0.
3. MoE training kernels at the layout of B 2 x T 4096 (16384 routed rows,
   M 18432, bm 256: every grouped kernel on wgmma), every operand row
   nonzero (pad rows and the clamped tail included): ``gmm_swiglu``
   writing h, gate and up; the down ``gmm``
   and both transposed-rhs dlhs ``gmm`` shapes (2e-2 of max |plain|, every
   row); ``tgmm`` at the gate/up ([M, 4096] x [M, 14336] -> [8, 4096,
   14336]) and down shapes against ``tgmm_plain`` in f32, each expert's
   block within ||kernel - plain|| / ||plain|| <= 1e-2; a negative control
   (the kernel's own block of the expert of tile 0 less its last tile's
   contribution) must fail that check; an expert no token picks must come
   out exactly zero.  Then ``gmm`` and ``tgmm`` under ``valid_tiles`` on a
   worst-case per-shard layout (2 local experts plus the sentinel group,
   about half the tiles real), and on the layouts the mesh MoE step
   builds from a router's top-2 over B 2 x T 4096 (``grouped_layout``
   with a local expert range): ep 1 (8 local experts, M 18688, 73 tiles:
   the one-card mesh of phase 13) and ep 4's first shard (2 local
   experts, M 17152): rows past ``valid_tiles`` exactly 0.  Each
   with ms, plain ms, ``library_ms`` (per-expert ``torch.matmul`` loops over
   the real rows) and the bound over the routed rows.
4. flash kernels: ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at the
   pretrain shape (B 4, H 32, T 4096, D 128, causal, bf16) against their
   plain versions (f32 math, full-precision f32 matmuls) on the same
   inputs, eight heads at a time.  Each row is compared on its own (a
   query row of o and dq, a key row of dk and dv): ||kernel - plain|| /
   ||plain|| <= 1e-2 in every row (p and ds are rounded to bf16 before
   their products, and the outputs to bf16: each a relative 2^-8 at most),
   the denominator floored at 1e-2 of the RMS row norm (causal dq row 0 is
   zero up to rounding); lse within 1e-3 absolute.  Negative controls:
   the same check must reject the kernels' own dk/dv with every key row
   from 1500 on zeroed, their o with every query row from 1024 on scaled
   by 0.7, and their dq with every query row from 2048 on scaled by 0.97.
   Also non-causal and head_dim 64 at small shapes, and T 320 and 192
   (T = 64 mod 128: the last 128-row block of each kernel runs past T).
   Prints each kernel's ms, its plain version's ms on the same inputs (16
   calls of 8 heads: its f32 scores are 512 MB a call), the bound at H100
   SXM peaks, and ``torch.nn.functional.scaled_dot_product_attention``'s
   fwd, bwd alone (dq, dk and dv in one call) and fwd+bwd ms (a yardstick
   the port never calls) beside ``flash_dq`` + ``flash_dkv`` and the
   backward wrapper's ``delta`` einsum.  Then B * H past 65535 (B 1024 x
   H 66, T 64, D 64): batches run alone must give bit-identical outputs
   to the full grid, and agree with the plain versions.  Last, the
   kernels' fwd+bwd against the plain attention path at T =
   1024/2048/4096 (B 1, H 32).
5. serve: ``LlamaBackend`` under a ``ServeEngine`` (8 slots, max_len 256,
   buckets 16/32/64/128) answers 8 requests of 12-120 prompt tokens and 16
   new tokens each.  The gmm launch counters are zeroed just before and
   read just after; both kernels must have launched.  Then one prefill
   of the first request, layer by layer: the plain path's input to each of
   the 8 layers' expert FFN (``moe.moe_ffn``, the grouped path) goes
   through the kernels and through the plain versions, and each layer
   must agree within max |kernel - plain| <= 2e-2 * max |plain| (the
   per-call limit; plain vs plain, differing only in f32 summation order,
   reads its floor: ``tools/prefill_logits_drift.py``, PERF.md).  A
   negative control, layer 0 through the kernels with the rows of one
   expert zeroed in the down gmm's output, must fail it.  The 8-layer
   logits difference and argmax agreement are printed, without a limit
   (rounding differences grow through 8 random-init bf16 layers past
   any useful limit).
6. profile: ``torch.profiler`` over decode steps and a 128-token prefill
   of the same backend: wall ms, device-busy ms, idle share and kernel
   time by group (PERF.md section 5), beside the experts each layer's
   routing touches in the same call and the time their weights take to
   read at 3.35 TB/s (the floor of ``gmm`` + ``gmm_swiglu``).
7. train check: Llama-2-7B widths at 2 layers, B 1, T 1024, one seed: the
   loss and every parameter gradient of the kernel path against the same
   step with the flash wrappers swapped for their plain versions.  Loss
   within 1e-2 relative; each gradient's ||g_kernel - g_plain|| /
   ||g_plain|| <= 5e-2.
8. train: ``llama_pretrain.train`` (the loop ``llama_pretrain.main`` runs)
   on ``LlamaConfig.llama2_7b()`` cut to 8 of 32 layers, remat "full",
   attention "auto", B 4 x T 4096 synthetic tokens, 5 steps of AdamW (lr
   3e-4, weight decay 0.1, clip 1.0).  The flash launch counters are zeroed
   just before and read just after: flash_fwd must have launched 2 x 8 x 5
   times (forward and remat recompute), flash_dq and flash_dkv 8 x 5.
   Every loss finite, the last below the first.  Prints step ms p50,
   tokens/s, peak memory, then steps 6 and 7 of the same loop (same
   optimizer state and tokens), the seventh under the profiler (kernel
   time by group, idle share).
9. MoE train check: ``mixtral_8x7b_train(1)``, B 1, T 1024: as phase 7,
   with ``gmm``, ``gmm_swiglu`` and ``tgmm`` (forward and backward) swapped
   for their plain versions; the same limits.
10. MoE train: ``llama_pretrain.train`` on ``mixtral_8x7b_train(2)`` (f32
   parameters, bf16 activations, remat "full", attention "auto", grouped
   dispatch), B 2 x T 4096, 5 steps as phase 8.  Launch counts exact: per
   layer per step ``gmm_swiglu`` 2 (forward, recompute), ``gmm`` 5 (down
   forward and recompute, down dlhs, the two SwiGLU dlhs), ``tgmm`` 3,
   ``flash_fwd`` 2, ``flash_dq`` and ``flash_dkv`` 1.  Peak memory under 80
   GB; the profiled seventh step as in phase 8.
11. remat policies at full width: ``llama_pretrain.train`` on the dense
   model of phase 8 (8 layers, B 4 x T 4096, seed 0: ``llama_pretrain.
   main``'s init) for 3 steps under each of "full", "dots", "ffn", "gateup"
   and "gateup_attn", and on ``mixtral_8x7b_train(2)`` (B 2 x T 4096,
   phase 10's seed) under "moe".  The launch
   counters are zeroed before each run and read after: per layer per step
   they must equal what ``tests/test_torch_remat.py`` holds the CPU to
   against the reference's jaxpr (``REMAT_LAUNCHES_PER_LAYER``: the flash
   forward re-runs under every policy; under "moe" ``gmm_swiglu`` re-runs
   and the down ``gmm`` is kept).  The dense first-step losses must be
   bit-identical across the five policies, and the MoE one to phase 10's
   under "full"; peak memory under 80 GB.  Prints each policy's step ms
   p50, peak memory and launches per step.
12. the mesh path on one card: ``llama_pretrain.main`` (``--preset
   llama2-7b --n-layers 8 --batch-size 4 --seq-len 4096 --steps 3 --dp 1
   --fsdp 1 --tp 1``) inside a one-rank nccl group formed by
   ``JobRuntime.join_group``, so on a real ``DeviceMesh`` with DTensor
   parameters and activations and the flash kernels per shard through
   ``local_map``.  It must print the mesh line; the flash launches must be
   exact (2 x 8 x 3 forward, 8 x 3 each backward); its per-step losses must
   be within 1e-5 relative of phase 11's "full" run on the same init and
   tokens (the largest difference is printed); step ms p50 and peak memory
   are printed beside that run's.
13. MoE under the mesh on one card: ``llama_pretrain.main`` (``--preset
   mixtral-8x7b --n-layers 2 --experts 8 --top-k 2 --moe-dispatch grouped
   --ep 1 --fsdp 1 --tp 1 --strict-moe-dispatch --batch-size 2 --seq-len
   4096 --steps 3``: phase 10's widths, f32 parameters, remat "full") in a
   one-rank nccl group, with phase 10's init and tokens (its seed), so
   on the ep-sharded dropless grouped path (``models/moe.py``: the
   shard's layout with a sentinel group, gate, up and down as separate
   ``gmm`` calls under ``valid_tiles``).  No fallback warning; launches
   exact, per layer per step: the skip forms of ``gmm`` 9 (gate, up and
   down, forward and recompute, and the three dlhs) and ``tgmm`` 3, and
   no other grouped launch (``gmm_swiglu`` 0), flash as phase 10 (the
   counts ``tests/test_torch_moe_mesh.py`` holds the CPU to against the
   reference's jaxpr under its mesh); per-step losses within 1e-3
   relative of phase 10's first three (the mesh runs gate and up as two
   products where phase 10 fuses them: the bf16 roundings differ), the
   largest difference printed; each layer's M, tiles and
   ``valid_tiles`` on the first step; step ms p50 and peak memory beside
   phase 10's, the peak under 80 GB.
14. entry point: ``llama_pretrain.main`` on the card's default device,
   ``--preset tiny --steps 2``, then with ``--experts 4 --moe-dispatch
   einsum``.
15. dist-mnist (the gang slice; it reaches no hand-written kernel, and
   every launch counter must read 0 across it): ``mnist_local.main([])``
   and ``mnist_dist.main([])`` with no ``--device``, so on CUDA, at the
   reference's defaults (200 steps, global batch 100, 8192 train and 2048
   eval examples; dist-mnist's default is the one-program scan fit, one
   CUDA graph); each must exit 0 with a finite final loss, and their
   sign-off lines are printed.  Then ``mnist_local``, dist-mnist's scan
   fit and its ``--step-loop`` again on CUDA and on the CPU from the same
   seed, f32 with TF32 off: every per-step loss within
   ``MNIST_LOSS_ATOL``.  Then a one-rank nccl group through
   ``JobRuntime.join_group``: one dist step through the flat
   ``all_reduce`` must leave the parameters bit-identical to the same step
   with no group (one card, and NCCL refuses two ranks on one device, so
   a one-rank group is the only form of the collective one card checks).
16. checkpoint/resume, in a child process of this script (``--resume-phase``,
   with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
   ``torch.use_deterministic_algorithms``, and a file-drop progress
   reporter from ``KCTPU_PROGRESS_DIR``, whose last beat must read
   ``phase="fit"`` at step 4, ``compileSource`` "cache-hit" and
   ``resumedFromStep`` 2): ``llama_pretrain.train`` at Llama-2-7B widths cut to 2
   layers (1 when the disk under ``smoke_ckpt/`` has under 20 GB free),
   B 1 x T 1024, attention "auto" (the flash kernels): 4 steps
   uninterrupted; then 2 steps with ``checkpoint_every=2`` into a fresh
   ``MODEL_DIR`` (an async save of step 2, ~8 GB of f32 parameters and
   AdamW moments), the model and optimizer dropped, and 2 more steps from
   the restored step.  The per-step losses and the final parameters must
   be bit-identical to the uninterrupted run's; the flash launches of the
   resumed run must be exact (2 x layers x 2 forward, layers x 2 each
   backward).  Prints the bytes written, the async save's blocking
   seconds (the host snapshot), the total save and restore seconds and
   their GB/s, and any op that warned it has no deterministic
   implementation.  The directory is deleted.
17. vision (no hand-written kernel; every launch counter must read 0):
   ``cifar_allreduce`` ResNet-50 at the published widths (``--width 64``:
   64 -> 2048 channels), batch 128, 20 steps, twice (the first run pays
   cuDNN's first calls), then ``flax_mnist.main([])`` at its defaults,
   with steps/s, images/s, peak memory and the TF32 flags (off).  Each
   against a CPU run of its first 3 steps at batch 32: ResNet-50's
   per-step losses within ``RESNET_LOSS_RTOL`` relative, the CNN's within
   ``MNIST_LOSS_ATOL``.  Then one ResNet-50 step (batch 32, cuDNN
   deterministic) with no group and in a one-rank nccl group: state and
   loss bit-identical, 2 x 53 + 1 collectives in the fit's CUDA graph
   (issued while it is captured; the warm-up's are printed beside).
18. sequence parallelism on one card (one card cannot hold an NCCL gang:
   the ring and Ulysses run over virtual ranks in this process, with the
   per-rank code of the gang's path, ``parallel/ring.py``,
   ``parallel/ulysses.py``) at Llama-2-7B's attention widths and
   ``examples/jobs/llama-sp.yaml``'s length: B 1, T 32768, H 32, D 128,
   bf16, causal.  The causal flash ring (``ring.run_lockstep``) at n = 4
   (T_local 8192) and n = 2, with the flash plain versions patched to raise:
   its output and the q/k/v gradients of a fixed random dO against one
   ``flash_attention`` call over the whole T (the kernels), every query row
   of o and dq and every key row of dk and dv within ``FLASH_ROW_TOL``;
   launches counted from 0 just before and read just after, each of
   ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` exactly n(n+1)/2 (rank idx
   folds idx + 1 blocks).  A control, each rank's backward reading its own
   diagonal block's lse in place of the merged one, must fail the same
   check.  Each ring's time per virtual rank (CUDA events around its
   kernels; the last rank's is the critical path) beside the one call's.
   Then the ring's visible-block calls at T_local 8192, non-causal, on 2
   heads, with rank 3's merged lse and delta: each kernel against its
   plain version row by row (the plain scores [1, 2, 8192, 8192] f32), with
   ms, plain ms and the bound.  Then Ulysses at n = 4 in process (the
   layout moves, ``flash_attention`` on 8 heads over the whole T): output
   and gradients against the one call, bit identity printed, rows within
   ``FLASH_ROW_TOL``, launches 4 each.
19. cached generation (``models/generate.py``: ``generate``,
   ``forward_with_cache``), B 8, 64 new tokens, greedy.  19a: Mixtral-8x7B
   widths (``mixtral_8x7b(8)``, bf16 parameters, grouped dispatch),
   512-token prompts (S 576, rounded up to 768: the blocked read over 3
   blocks), with the grouped kernels' plain versions patched to raise:
   ``gmm_swiglu`` and ``gmm`` launch exactly 8 x (1 + 63) = 512 times each
   (the prefill's 8192 routed rows on the wgmma design, each decode step's
   16 on the swap-AB one), the flash kernels 0; each prefill layer's
   expert FFN, kernels against plain versions on the plain path's input,
   within ``LAYER_REL_TOL`` of max, and a control with one expert's rows
   zeroed must fail that check; printed, not gated: the whole prefill
   logits against the plain path's, the share of tokens each layer routes
   differently (bf16 rounding flips top-2 choices) and the greedy tokens
   the two paths agree on; prefill ms, ms per token (p50 of the 63
   steps), peak GB, the weight bytes a decode step reads over the touched
   experts with their floor at ``PEAK_HBM_BYTES``, and one profiled
   decode token.  19b: Llama-2-7B at all 32 layers (bf16
   parameters, ``llama2_7b_decode``), 2048-token prompts, in four
   variants: the bf16 and the int8 cache, each with the blocked read (S
   2112 -> 2304, 9 blocks) and the dense one (``kv_block`` 4096 > S): for
   each prefill ms, ms per token, peak and cache GB, launches per decode
   token and the idle share of one profiled token; every launch counter 0;
   blocked against dense, the tokens they agree on and their largest
   logit difference at each step; then the int8 cache against the bf16
   one, teacher-forced over the bf16 run's 64 positions: the largest logit
   difference and the argmax agreement (printed, not gated); then one
   blocked prefill of B 8 x 4096 tokens (S 4352): its ms and peak GB, and
   the peak over the model and cache must stay below the f32 scores one
   unchunked pass of a layer's read would hold.  19c:
   ``generate(mesh=)`` at Llama-2-7B widths (8 layers) in a one-rank nccl
   group: tokens bit-identical to the run with no mesh, host ms per token
   beside it.
20. pipeline parallelism on one card, through ``llama_pretrain.train(pp=,
   microbatches=)`` on virtual stages in this process
   (``parallel/pipeline.py:Lockstep``; the 1F1B schedule of
   ``models/llama.py:llama_loss_and_grads_pp``), every kernel's plain
   version patched to raise.  20a: Llama-2-7B widths, 8 layers, B 4 x T
   4096, (pp 4) x 2 layers, M 4: one 1F1B step against ``llama_loss`` +
   backward on the same init and batch (loss within 1e-3 relative, every
   gradient within 5e-2 relative norm), its launches exact
   (``PP_LAUNCHES_PER_LAYER`` times the layers and the real microbatches:
   a bubble launches nothing), then 3 steps of ``train``, launches exact,
   ms p50 and peak GB beside phase 8's step.  20b: Mixtral-8x7B widths, 2
   layers, grouped, B 2 x T 4096, (pp 2) x 1 layer: M 1 against
   ``llama_loss`` with its router penalties (the same limits), then 3
   steps at M 2; ``gmm``/``gmm_swiglu``/``tgmm`` and flash launches exact
   (``PP_MOE_LAUNCHES_PER_LAYER``).
21. the graft-entry hooks and the workload traces.  21a:
   ``graft_entry.entry()`` with no device, so on the card: the flagship
   forward's logits [2, 64, 512] f32, finite, and its ms.  21b: under one
   job's trace context and dir (``$KCTPU_TRACE_CONTEXT``,
   ``$KCTPU_TRACE_DIR``) and a file-drop reporter, three child processes
   at once as the node agent starts them: ``llama_pretrain --preset tiny
   --steps 2``, ``mnist_dist --steps 20 --step-loop`` and ``mnist_local
   --steps 20``
   on the card.  Their dumps (one event a span id, as the controller's
   merge keeps them) must be one tree under the context (every span of
   its trace, each parent a span of the dumps or the context's root
   span), holding exactly ``workload/compile`` with source "cache-hit"
   (phase 1 built the library), ``workload/first_step`` three times (the
   pretrain's first beat, the dist step loop's span and its first beat),
   the dist fit's spans (``workload/rendezvous``, ``workload/init``,
   ``workload/fit`` twice, ``workload/stage``, ``workload/host_setup``)
   and ``workload/train``.  21c: phase 5's 8 requests, on a
   ``LlamaBackend`` at Mixtral-8x7B widths cut to 2 layers, through a
   ``ServeEngine`` built under a trace context: 8 ``serve/request`` spans
   under the context's root, each with ``serve/queue_wait``,
   ``serve/prefill`` and ``serve/decode`` under it, in that order and
   within it; the grouped kernels' launches counted from 0 (path
   ``serve_traced``).
22. pipeline parallelism under sequence parallelism, rank by rank.  One
   card cannot give an sp axis real values (the contract is one card,
   and nccl takes one rank a device), so each of the four ranks of a (pp
   2, sp 2) mesh runs alone on the card under torch's fake process group
   (collectives and hand-offs do nothing; DTensor's sharding propagation
   runs in full on this torch): one step of ``llama_pretrain.train(mesh=,
   microbatches=2)`` at Llama-2-7B widths, 4 layers (2 a stage), bf16
   activations, attention "flash", remat "full", B 2 x T 8192, ring on
   one pass and Ulysses on the other.  Every plain version raises and the
   flash fallback warning is an error; each rank's flash launches must
   equal ``pp_sp_launches_per_layer`` of its sp index (the CPU test's
   counts) times its 2 layers and 2 microbatches.  The values come from
   the 4-card run (``tools/mesh_cards.py --pp --sp``).
23. the pod path on one card (``workloads/launch.py``), its card bound
   by the port's inventory (``cluster/gpu.py``), in a child process of
   this script (``--pod-phase``, with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``):
   ``topology.discover_host`` reads this host's cards (the visible ones
   matched by UUID to ``nvidia-smi``'s list; their NVLink domains from
   ``nvidia-smi topo -p2p n``), printed on one line with the card line
   and the domains; a ``GPUInventory``
   of ``carve(host, 1)`` admits the one pod of a one-host ``h100-1`` TPU
   job (a stand-in pod with ``_wire_tpu_pod``'s annotations) through
   ``offer`` and sets its ``CUDA_VISIBLE_DEVICES`` to the bound card's
   UUID.  ``llama_pretrain.main`` at Llama-2-7B widths, 2 layers, B 1 x T
   4096, 3 steps, runs in a one-rank nccl group on that card in that
   process (flash launches counted from 0 just before and read just
   after), then the same flags as the pod: a child ``python -m
   kubeflow_controller_tpu_torch.workloads.llama_pretrain --device cuda
   --report`` with the env the controller gives the pod (``pod_env``:
   ``JAX_NUM_PROCESSES`` 1, ``TPU_ACCELERATOR_TYPE`` h100-1, the node
   agent's loopback coordinator) and the cards the inventory set, so the
   contract's count of cards is 1.  The pod's launcher must have started
   one rank, which formed a one-rank nccl group on the bound card (its
   report: launched, world 1, local 0/1, ``cuda:0``, the bound card's
   UUID; its mesh line "over 1 devices, process 0/1"); its flash
   launches, printed in its report, must be exact (2, 1 and 1 a layer a
   step, as the in-process run's), and its losses bit-identical to the
   in-process run's.  Then ``release_gang`` must free the card, a second
   ``offer`` bind it again, and ``fail_slice`` return the pod's key and
   withhold the card.  The pod's wall seconds and its first step's end
   after the spawn are printed.
24. the one-program fits (no hand-written kernel; every launch counter
   must read 0): ``mnist_dist``'s default scan fit (200 steps, the
   threefry data drawn in the graph), ``mnist_local``, ``flax_mnist`` and
   ``cifar_allreduce`` (ResNet-18, width 16) at their defaults, each one
   ``trainer.OneProgram``.  A profiler on from the capture's end to the
   sync must see one ``cudaGraphLaunch`` and no kernel launch; Adam's
   step count must read the fit's steps; each fit's capture s, replay ms,
   µs a step and the same body's eager µs a step on the card (the graph
   patched off), with the two runs' largest loss difference, are printed.
   The threefry draw of the train and eval sets is timed alone (CUDA
   events) beside the dist-mnist replay.  Then the scan fit (50 steps)
   with no group and in a one-rank nccl group: the captured collectives
   (n_params + 1 a step, 2 for the eval) give losses and parameters
   bit-identical.
25. The card's name and power limit, the ``kernels`` JSON line (launches
   from phase 10; each path's own counts beside them, phase 13's, the
   sequence-parallel paths ``ring_n4``, ``ring_n2`` and ``ulysses_n4``,
   ``generate``, phase 19a's, ``pp_dense`` and ``pp_moe``, phase 20's
   timed runs, ``pp_sp_ring`` and ``pp_sp_ulysses``, phase 22's four
   ranks summed, ``pod``, phase 23's pod, and ``one_program``, phase 24's
   fits, with the skip launches of ``gmm`` and ``tgmm``, and the
   serve and generate runs' grouped launches by design; each flash entry's
   ``sp_block``: the block kernels of phase 18, SDPA's backward as the
   library time of dq and dkv), and the contract line ``{"ok": true,
   "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from kubeflow_controller_tpu_torch.models import llama as llama_mod
from kubeflow_controller_tpu_torch.models import moe
from kubeflow_controller_tpu_torch.models.generate import init_paged_cache, paged_prefill
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import attention as at
from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm
from kubeflow_controller_tpu_torch.parallel.ring import attention_reference
from kubeflow_controller_tpu_torch.models import mnist
from kubeflow_controller_tpu_torch import graft_entry
from kubeflow_controller_tpu_torch.cluster import gpu as gpu_inventory
from kubeflow_controller_tpu_torch.cluster import topology
from kubeflow_controller_tpu_torch.obs import trace
from kubeflow_controller_tpu_torch.workloads import (
    cifar_allreduce,
    compile_cache,
    flax_mnist,
    llama_pretrain,
    mnist_dist,
    mnist_local,
    progress,
)
from kubeflow_controller_tpu_torch.workloads.data import synthetic_tokens
from kubeflow_controller_tpu_torch.workloads.launch import free_port
from kubeflow_controller_tpu_torch.workloads.runtime import JobRuntime
from kubeflow_controller_tpu_torch.workloads.serve import (
    LlamaBackend,
    Request,
    ServeConfig,
    ServeEngine,
)

# The module by its name: the package exports the function ``generate``.
gen_mod = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")

# H100 SXM published peaks (dense bf16, HBM3), at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_REL_TOL = 2e-2
LAYER_REL_TOL = KERNEL_REL_TOL     # per layer: each layer's expert FFN
SOURCE = "kubeflow_controller_tpu_torch/csrc/grouped_matmul.cu"
REF_FILE = "kubeflow_controller_tpu/ops/grouped_matmul.py"
FLASH_SOURCE = "kubeflow_controller_tpu_torch/csrc/flash_attention.cu"
FLASH_REF = "kubeflow_controller_tpu/ops/attention.py"
FLASH_ROW_TOL = 1e-2               # per row: ||kernel - plain|| / ||plain||
ROW_FLOOR = 1e-2                   # of the RMS row norm, the denominator's floor
FLASH_OUTS = ("o", "dq", "dk", "dv")
LSE_ATOL = 1e-3
TRAIN_LOSS_RTOL = 1e-2
# dist-mnist, CUDA vs CPU, f32 with TF32 off: each of the 200 per-step
# losses.  Only the summation order differs, as between the port and the
# JAX package on the CPU, which tests/test_torch_mnist.py holds to the
# same 1e-4 a step.
MNIST_LOSS_ATOL = 1e-4
# ResNet-50 on the card against the CPU, per-step loss over 3 steps,
# relative: f32 on both (TF32 off), other convolution algorithms and
# summation orders.  Two card runs read 7.8e-8 and 0 (PERF.md); the limit
# leaves two orders of magnitude above the larger for a ReLU input within
# rounding of 0 that flips on one side only.
RESNET_LOSS_RTOL = 1e-5
RESNET50_BN_LAYERS = 53
# Checkpoints and beat drops of this run live in the checkout, and go.
SMOKE_DIR = Path(__file__).resolve().parent / "smoke_ckpt"
RESUME_DISK_BYTES = 20e9        # two 2-layer steps (~8 GB each) and room
TRAIN_GRAD_RTOL = 5e-2
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
FLASH_SHAPE = (4, 4096, 32, 128)    # the pretrain shape: B, T, H, D
MANY_HEADS = (1024, 64, 66, 64)     # B * H = 67584, past the old 65535
MANY_HEADS_SLICES = (0, 993, 1023)  # from batch 993 on, every head >= 65536
PLAIN_HEADS = 8                     # heads per plain-version call
SWEEP_T = (1024, 2048, 4096)
CHECK_SEQ = 1024                    # the card-side training check's T
TGMM_REL_TOL = 1e-2                 # per expert: ||kernel - plain|| / ||plain||
TGMM_SOURCE_LINES = (f"{REF_FILE}:338 (_tgmm_kernel); "
                     f"{REF_FILE}:364 (_tgmm_skip_kernel)")
GROUPED_KERNELS = ("gmm_swiglu", "gmm", "tgmm")
MOE_TRAIN = {"layers": 2, "batch": 2, "seq_len": 4096}
MOE_CHECK = {"layers": 1, "batch": 1, "seq_len": 1024}
# Kernel launches per layer per step of the MoE train path under remat
# "full" (forward, and the recompute in the backward).
MOE_LAUNCHES_PER_LAYER = {"gmm_swiglu": 2, "gmm": 5, "tgmm": 3,
                          "flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}


def mixtral_8x7b(n_layers: int = 8) -> LlamaConfig:
    """mistralai/Mixtral-8x7B-v0.1 config.json widths; depth cut to
    ``n_layers`` of 32 (all 32 are ~93 GB in bf16, over the card's 80)."""
    return LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, intermediate=14336, max_seq_len=32768,
        rope_theta=1e6, norm_eps=1e-5, dtype="bfloat16",
        param_dtype="bfloat16", remat=False, n_experts=8, moe_top_k=2,
        moe_dispatch="grouped")


def mixtral_8x7b_train(n_layers: int = 2) -> LlamaConfig:
    """Mixtral-8x7B widths (``mixtral_8x7b``) set for training as the
    reference trains: f32 parameters, bf16 activations, remat "full",
    attention "auto" (the flash kernels at T >= 1024), grouped dispatch.
    Depth cut to ``n_layers`` of 32: each layer is ~1.451 B parameters, 16 B
    each as f32 parameter, gradient and two AdamW moments, so two layers
    plus embed and lm_head (~3.16 B) hold ~50.6 GB of training state."""
    return replace(mixtral_8x7b(n_layers), param_dtype="float32", remat=True,
                   remat_policy="full", attention="auto")


def llama2_7b(n_layers: int = 8) -> LlamaConfig:
    """meta-llama/Llama-2-7b widths (``LlamaConfig.llama2_7b()``: vocab
    32000, dim 4096, 32 heads, 32 kv heads, intermediate 11008, rope theta
    1e4, bf16 activations, f32 parameters, remat "full", attention "auto");
    depth cut to ``n_layers`` of 32 (32 layers' f32 parameters, gradients
    and AdamW moments are ~108 GB, over the card's 80)."""
    return replace(LlamaConfig.llama2_7b(), n_layers=n_layers)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

# The kernels' names: the wgmma designs (the swap-AB decode kernel among
# them) must issue HGMMA (wgmma) instructions, the WMMA one (tgmm at bm <
# 64) must not.
WGMMA_KERNELS = ("gmm_wgmma_kernel", "gmm_swiglu_wgmma_kernel",
                 "tgmm_wgmma_kernel", "gmm_swapab_kernel",
                 "flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                 "flash_dkv_wgmma_kernel")
WMMA_KERNELS = ("tgmm_kernel",)
# Mangled: <length><identifier>I<template args>... (or E and the
# parameters, for a kernel that is not a template).
KERNEL_NAME = re.compile(r"\d((?:t?gmm|gmm_swiglu|flash_fwd|flash_dq|"
                         r"flash_dkv)_(?:wgmma_|swapab_)?kernel)([IE])")


def hgmma_counts(sass: str) -> dict:
    """HGMMA instructions per kernel of ``WGMMA_KERNELS`` and
    ``WMMA_KERNELS`` in ``cuobjdump -sass`` output: {kernel name: [count
    per instantiation]}."""
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = KERNEL_NAME.search(line)
            name = m.group(1) if m else None
            if name is not None:
                counts.setdefault(name, []).append(0)
        elif name is not None and "HGMMA" in line:
            counts[name][-1] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """{kernel<template args>: [registers, spill store bytes, spill load
    bytes]} of every kernel named by ``KERNEL_NAME`` in ptxas -v output."""
    report: dict = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = KERNEL_NAME.search(line)
            name = None
            if m:
                args = re.findall(r"L[ib](\d+)E",
                                  line[m.end():].split("EE")[0] + "E") \
                    if m.group(2) == "I" else []
                name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
                report[name] = [None, None, None]
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                report[name][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name][0] = int(m.group(1))
    return report


@dataclass
class RecordingReporter(progress.ProgressReporter):
    """A file-drop reporter that also keeps the fields of every beat."""

    beats: list = field(default_factory=list)

    def beat(self, **fields):
        self.beats.append({k: v for k, v in fields.items() if v is not None})
        super().beat(**fields)


def built_library():
    """The kernel build through ``compile_cache.build_kernels`` under a
    recording file-drop reporter: the window beats ``phase="compile"``
    (and the dropped file reads it), and the source returned is
    "compiled" when the content-keyed library was absent before the call,
    "cache-hit" otherwise.  Returns the library."""
    path = (_build.BUILD_DIR
            / f"libkctpu_kernels_{_build._content_key(_build.key_files())}.so")
    want = "cache-hit" if path.exists() else "compiled"
    SMOKE_DIR.mkdir(exist_ok=True)
    drop = tempfile.mkdtemp(dir=SMOKE_DIR)
    try:
        rep = RecordingReporter(name="chip-smoke", drop_dir=drop)
        source = compile_cache.build_kernels(torch.device("cuda", 0), rep)
        with open(os.path.join(drop, progress.drop_filename(
                rep.namespace, rep.name))) as fh:
            dropped = json.load(fh)
    finally:
        shutil.rmtree(drop, ignore_errors=True)
    lib = _build.library()
    print("build: beats " + json.dumps(rep.beats) + f", source {source!r} "
          f"(want {want!r}); the drop file reads {json.dumps(dropped)}",
          flush=True)
    assert rep.beats == [{"phase": "compile"}], rep.beats
    assert dropped == {"phase": "compile"}, dropped
    assert source == want and lib.compile_source == want, (source, want)
    return lib


def build_phase():
    lib = built_library()
    print(f"build: {lib.build_seconds:.3f} s -> {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if any(w in line.lower() for w in ("warning", "performance loss")):
            print(f"  ptxas: {line.strip()}")
    regs = ptxas_report(lib.log)
    print("build: ptxas [registers, spill stores, spill loads] per kernel: "
          + json.dumps(regs), flush=True)
    print("build: swap-AB decode kernels (gmm_swapab_kernel<NR, SWIGLU, "
          "TRANS>) [registers, spill stores, spill loads]: " + json.dumps(
              {k: v for k, v in regs.items() if "swapab" in k}), flush=True)
    assert all(r[1] == 0 and r[2] == 0 for r in regs.values()), (
        "ptxas spilled registers")
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib.path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = hgmma_counts(sass)
    print("build: HGMMA instructions per kernel instantiation: "
          + json.dumps(counts), flush=True)
    for name in WGMMA_KERNELS:
        assert counts.get(name) and all(counts[name]), (
            f"{name}: no HGMMA instruction")
    for name in WMMA_KERNELS:
        assert counts.get(name) and not any(counts[name]), (
            f"{name}: HGMMA in the WMMA design")
    return lib


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def routed_layout(cfg: LlamaConfig, n_tok: int, gen: torch.Generator, dev,
                  empty=None, picked=None):
    """The grouped layout of ``n_tok`` tokens under a random router that
    never picks expert ``empty`` and always picks expert ``picked`` for
    token 0 (each if given), and the per-expert slot counts."""
    logits = torch.randn((1, n_tok, cfg.n_experts), generator=gen,
                         device=dev)
    if empty is not None:
        logits[..., empty] = -1e9
    if picked is not None:
        logits[0, 0, picked] = 1e9
    _, idx = moe.router_topk(logits, cfg.moe_top_k)
    lay = moe.grouped_layout(idx, cfg.n_experts, 256)
    counts = np.bincount(idx.reshape(-1).cpu().numpy(),
                         minlength=cfg.n_experts)
    return lay, counts


def layout_case(cfg: LlamaConfig, n_tok: int, gen: torch.Generator, dev,
                empty=None, picked=None):
    """The grouped layout of ``n_tok`` random tokens under a random
    router (``routed_layout``'s ``empty`` and ``picked``), the lhs the FFN
    kernels see, and the host-side group sizes."""
    lay, counts = routed_layout(cfg, n_tok, gen, dev, empty, picked)
    x = (torch.randn((n_tok, cfg.dim), generator=gen, device=dev)
         ).to(torch.bfloat16)
    x_pad = moe._dispatch_rows(x, lay.inv_src, lay.dest.reshape(n_tok, -1))
    return lay, x_pad, counts


def groups(counts, bm):
    """(expert, first row, row count) of every non-empty expert group."""
    out, off = [], 0
    for e, c in enumerate(counts):
        if c:
            out.append((e, off, int(c)))
        off += -(-int(c) // bm) * bm
    return out


def check_rel(name, got, ref, rows, tol):
    got = got.index_select(0, rows).float()
    ref = ref.index_select(0, rows).float()
    assert torch.isfinite(got).all(), f"{name}: non-finite kernel output"
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  {name}: max_abs_err {err:.6g} (max |plain| {scale:.6g}, "
          f"rel {err / scale:.3g}, tol {tol})", flush=True)
    assert err <= tol * scale, f"{name}: kernel disagrees with plain version"
    return err


def timed(fn, plain, library, nbytes, flops, err, iters=5, plain_iters=1,
          **extra):
    """Kernel, plain and library ms on the same inputs, the bound, and the
    bytes/s the kernel reached over the bytes the bound counts."""
    b_ms, b_by = bound(nbytes, flops)
    ms = time_ms(fn, iters)
    return {"ms": ms,
            "plain_ms": time_ms(plain, plain_iters, warmup=1),
            "library_ms": time_ms(library, iters), "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err,
            "bound_bytes_GBps": nbytes / ms / 1e6, **extra}


def print_times(name, shape, rec):
    print(f"  {name}[{shape}]: {rec['ms']:.4f} ms kernel, "
          f"{rec['plain_ms']:.4f} ms plain, {rec['library_ms']:.4f} ms "
          f"library, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)


def kernel_phase(cfg: LlamaConfig, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, e = cfg.dim, cfg.intermediate, cfg.n_experts

    def w(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(torch.bfloat16)

    wg, wu, wd = w((e, d, f)), w((e, d, f)), w((e, f, d))
    results = {}
    # (name, tokens, expert the router never picks, expert token 0 always
    # picks, timed calls): decode (bm 16), decode with E - 1 routed and
    # with E - 1 unrouted (then the clamped tail tiles alone read its
    # weights), the 16-token prefill bucket (bm 32) and the 128-token one
    # (bm 256).
    for shape, n_tok, empty, picked, iters in (
            ("decode", 8, None, None, 20),
            ("decode_last_expert_routed", 8, None, e - 1, 20),
            ("decode_last_expert_unrouted", 8, e - 1, None, 20),
            ("prefill_16", 16, None, None, 20),
            ("prefill", 128, None, None, 10)):
        lay, x_pad, counts = layout_case(cfg, n_tok, gen, dev, empty, picked)
        bm, te, rows = lay.bm, lay.tile_experts, lay.dest
        n_rows, used = int(counts.sum()), int((counts > 0).sum())
        grp = groups(counts, bm)
        tail = lay.m // bm - sum(-(-int(c) // bm) for c in counts)
        print(f"{shape}: M={lay.m} bm={bm} routed rows={n_rows} "
              f"experts touched={used} clamped tail tiles={tail} "
              f"(expert {e - 1} routed: {bool(counts[e - 1])})", flush=True)

        h = gm.gmm_swiglu(x_pad, wg, wu, te, bm)
        torch.cuda.synchronize()
        ref_h = gm.gmm_swiglu_plain(x_pad.float(), wg.float(), wu.float(),
                                    te, bm)
        err_h = check_rel(f"gmm_swiglu[{shape}]", h, ref_h, rows,
                          KERNEL_REL_TOL)
        del ref_h
        y = gm.gmm(h, wd, te, bm)
        torch.cuda.synchronize()
        ref_y = gm.gmm_plain(h.float(), wd.float(), te, bm)
        err_y = check_rel(f"gmm[{shape}]", y, ref_y, rows, KERNEL_REL_TOL)
        del ref_y

        def lib_swiglu():
            for ex, r0, c in grp:
                xe = x_pad[r0:r0 + c]
                torch.nn.functional.silu(xe @ wg[ex]) * (xe @ wu[ex])

        def lib_down():
            for ex, r0, c in grp:
                h[r0:r0 + c] @ wd[ex]

        sw_bytes = 2 * (n_rows * d + 2 * used * d * f + n_rows * f)
        dn_bytes = 2 * (n_rows * f + used * f * d + n_rows * d)
        sw_flops = 2 * 2 * n_rows * d * f
        dn_flops = 2 * n_rows * f * d
        for name, fn, plain, lib_fn, nbytes, flops, err in (
            ("gmm_swiglu", lambda: gm.gmm_swiglu(x_pad, wg, wu, te, bm),
             lambda: gm.gmm_swiglu_plain(x_pad, wg, wu, te, bm), lib_swiglu,
             sw_bytes, sw_flops, err_h),
            ("gmm", lambda: gm.gmm(h, wd, te, bm),
             lambda: gm.gmm_plain(h, wd, te, bm), lib_down,
             dn_bytes, dn_flops, err_y),
        ):
            rec = timed(fn, plain, lib_fn, nbytes, flops, err, iters=iters,
                        plain_iters=3, M=lay.m, bm=bm, routed_rows=n_rows,
                        experts_touched=used, clamped_tail_tiles=tail,
                        last_expert_routed=bool(counts[e - 1]))
            results.setdefault(name, {})[shape] = rec
            print_times(name, shape, rec)
        del h, y, x_pad
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


# Small ragged shapes: K and N multiples of 8 but not of the wgmma tiles
# (64 deep; 256 columns, 128 for gmm_swiglu and the swap-AB kernels; 128
# K rows for tgmm), so TMA's edge zero-fill and the masked stores run,
# at bm 64 and 128 (wgmma) and 4, 8, 16 and 32 (swap-AB; tgmm on WMMA).
# At bm 4 the swap-AB kernel's 8 rows run into the next tile; at bm 8-32
# a gmm block takes up to 64 / bm tiles of a run (expert 2's four tiles:
# one block at bm 8 and 16, two at 32), cut short at valid_tiles.
RAGGED_K, RAGGED_N = 200, 328
RAGGED_TILES = (0, 0, 2, 2, 2, 2)   # expert 1 owns no tile
RAGGED_VALID = 3                    # valid_tiles: tiles 3-5 skipped
RAGGED_BMS = (64, 128, 4, 8, 16, 32)


def ragged_phase(dev, seed: int):
    """gmm_swiglu (h, gate and up, every row within KERNEL_REL_TOL of max),
    gmm (rhs [E, K, N] and [E, N, K], with and without valid_tiles,
    every row within KERNEL_REL_TOL of max, skipped rows exactly 0) and
    tgmm (per expert within TGMM_REL_TOL, the tile-short control, the
    unrouted expert exactly 0) at RAGGED_K x RAGGED_N for each bm in
    RAGGED_BMS."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    k, n, e = RAGGED_K, RAGGED_N, max(RAGGED_TILES) + 1

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    te = torch.tensor(RAGGED_TILES, dtype=torch.int32, device=dev)
    vt = torch.tensor([RAGGED_VALID], dtype=torch.int32, device=dev)
    res = {"gmm": {}, "gmm_swiglu": {}, "tgmm": {}}
    for bm in RAGGED_BMS:
        m = len(RAGGED_TILES) * bm
        rows = torch.arange(m, device=dev)
        lhs, dout = rnd(m, k), rnd(m, n)
        weights = {False: rnd(e, k, n, scale=0.1),
                   True: rnd(e, n, k, scale=0.1)}
        variant = gm.kernel_variant("gmm", bm)
        name = f"gmm_swiglu[ragged {variant} bm{bm}]"
        w_up = rnd(e, k, n, scale=0.1)
        got = gm._gmm_swiglu(lhs, weights[False], w_up, te, bm, gate_up=True)
        torch.cuda.synchronize()
        ref = gm.gmm_swiglu_plain(lhs.float(), weights[False].float(),
                                  w_up.float(), te, bm, gate_up=True)
        res["gmm_swiglu"][name] = max(
            check_rel(f"{name}.{key}", g, r, rows, KERNEL_REL_TOL)
            for key, g, r in zip(("h", "gate", "up"), got, ref))
        for trans, valid in ((False, None), (True, None), (False, vt),
                             (True, vt)):
            name = (f"gmm[ragged {variant} bm{bm}"
                    + (" rhs^T" if trans else "")
                    + (" valid_tiles" if valid is not None else "") + "]")
            w = weights[trans]
            got = gm._gmm(lhs, w, te, bm, valid, transpose_rhs=trans)
            torch.cuda.synchronize()
            ref = gm.gmm_plain(lhs.float(), w.float(), te, bm, valid,
                               transpose_rhs=trans)
            res["gmm"][name] = check_rel(name, got, ref, rows, KERNEL_REL_TOL)
            if valid is not None:
                assert not got[RAGGED_VALID * bm:].any(), (
                    f"{name}: nonzero rows past valid_tiles")
        for valid in (None, vt):
            name = (f"tgmm[ragged {gm.kernel_variant('tgmm', bm)} bm{bm}"
                    + (" valid_tiles" if valid is not None else "") + "]")
            _, chk = tgmm_check(name, lhs, dout, te, e, bm, valid, empty=(1,),
                                control=valid is None)
            res["tgmm"][name] = chk["max_expert_rel"]
    return res


# ---------------------------------------------------------------------------
# Phase 3: the MoE training kernels at the training layout
# ---------------------------------------------------------------------------

def shard_layout(n_slots: int, n_local: int, gen: torch.Generator, dev):
    """A worst-case per-shard layout of the ep-sharded path (the
    reference's ``_grouped_ffn_sharded``): a row for every routing slot,
    ``n_local`` local experts plus a sentinel group that takes the
    non-local half of the slots, tile owners clamped to ``n_local - 1``,
    and ``valid_tiles`` the sentinel group's first tile.  Returns
    (tile_experts, valid_tiles, M, bm, local slot counts)."""
    local = torch.rand((n_slots,), generator=gen, device=dev) < 0.5
    expert = torch.randint(0, n_local, (n_slots,), generator=gen, device=dev)
    slot_e = torch.where(local, expert, n_local)
    lay = moe.grouped_layout(slot_e[:, None], n_local + 1, 256)
    counts = np.bincount(slot_e.cpu().numpy(), minlength=n_local + 1)
    real_tiles = sum(-(-int(c) // lay.bm) for c in counts[:n_local])
    te = lay.tile_experts.clamp(max=n_local - 1)
    vt = torch.tensor([real_tiles], dtype=torch.int32, device=dev)
    return te, vt, lay.m, lay.bm, counts[:n_local]


def expert_rel_errs(got, ref):
    """Per expert block: ||got[e] - ref[e]|| / ||ref[e]|| (0 where both are
    zero, inf where only ref is)."""
    errs = []
    for e in range(ref.shape[0]):
        diff = (got[e].float() - ref[e]).norm().item()
        norm = ref[e].norm().item()
        errs.append(diff / norm if norm else (0.0 if diff == 0 else math.inf))
    return errs


def tgmm_check(name, lhs, dout, te, n_experts, bm, valid_tiles=None,
               empty=(), control=False):
    """tgmm against tgmm_plain (f32) on the same inputs, expert by expert
    within ``TGMM_REL_TOL``; experts in ``empty`` must be exact zeros.  The
    negative control (``control``) removes the last tile's contribution
    from the kernel's own block of the expert owning tile 0, and the check
    must reject it."""
    got = gm.tgmm(lhs, dout, te, n_experts, bm, valid_tiles)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), f"{name}: non-finite kernel output"
    ref = gm.tgmm_plain(lhs.float(), dout.float(), te, n_experts, bm,
                        valid_tiles)
    rel = expert_rel_errs(got, ref)
    out = {"max_expert_rel": max(rel), "expert_rel": rel,
           "max_abs_err": max((got[e].float() - ref[e]).abs().max().item()
                              for e in range(n_experts)),
           "tol": TGMM_REL_TOL}
    if empty:
        out["empty_experts_exact_zero"] = {
            int(e): not got[e].any().item() for e in empty}
    if control:
        te_np = te.cpu().numpy()
        e0 = int(te_np[0])
        last = int(np.nonzero(te_np == e0)[0].max())
        rows = slice(last * bm, (last + 1) * bm)
        bad = got[e0].float() - lhs[rows].float().t() @ dout[rows].float()
        out["control"] = {"expert": e0, "tile": last, "rel": (
            (bad - ref[e0]).norm() / ref[e0].norm()).item()}
    del ref
    print(f"  {name}: " + json.dumps(out), flush=True)
    assert out["max_expert_rel"] <= TGMM_REL_TOL, f"{name}: kernel disagrees"
    assert all(out.get("empty_experts_exact_zero", {}).values()), (
        f"{name}: an expert with no tile is not exactly zero")
    if control:
        assert out["control"]["rel"] > TGMM_REL_TOL, (
            f"{name}: the check passed a tile-short expert block")
    return got, out


def moe_kernel_phase(cfg: LlamaConfig, dev, seed: int, batch: int = 2,
                     seq_len: int = 4096):
    """The grouped-matmul kernels as the MoE train step launches them, at
    the layout of B ``batch`` x T ``seq_len`` tokens (top-2: 16384 routed
    rows, M 18432, bm 256 at B 2 x T 4096): gmm_swiglu with gate and up,
    the down gmm, both transposed-rhs dlhs gmms, tgmm at the gate/up and
    down shapes, and gmm and tgmm under ``valid_tiles`` on a per-shard
    layout.  Every row of every operand is nonzero (pad rows and the
    clamped tail included, which add into expert E - 1 in the reference
    too)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d, f, e = cfg.dim, cfg.intermediate, cfg.n_experts

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    n_tok = batch * seq_len
    lay, counts = routed_layout(cfg, n_tok, gen, dev)
    m, bm, te = lay.m, lay.bm, lay.tile_experts
    n_rows, used = int(counts.sum()), int((counts > 0).sum())
    grp = groups(counts, bm)
    layout = {"M": m, "bm": bm, "routed_rows": n_rows, "tiles": m // bm,
              "experts_touched": used}
    print(f"moe train layout (B{batch} x T{seq_len}): " + json.dumps(layout),
          flush=True)
    x, g, dy = rnd(m, d), rnd(m, f), rnd(m, d)
    wg, wu, wd = (rnd(e, d, f, scale=0.02), rnd(e, d, f, scale=0.02),
                  rnd(e, f, d, scale=0.02))
    rows = torch.arange(m, device=dev)
    res = {name: {} for name in GROUPED_KERNELS}

    # Forward: gmm_swiglu with gate and up, then the down gmm.
    h, gate, up = gm._gmm_swiglu(x, wg, wu, te, bm, gate_up=True)
    torch.cuda.synchronize()
    ref = gm.gmm_swiglu_plain(x.float(), wg.float(), wu.float(), te, bm,
                              gate_up=True)
    err = max(check_rel(f"gmm_swiglu[train].{k}", got, r, rows,
                        KERNEL_REL_TOL)
              for k, got, r in zip(("h", "gate", "up"), (h, gate, up), ref))
    del ref, gate, up

    def lib_swiglu():
        for ex, r0, c in grp:
            xe = x[r0:r0 + c]
            ge, ue = xe @ wg[ex], xe @ wu[ex]
            torch.nn.functional.silu(ge) * ue

    res["gmm_swiglu"]["train"] = timed(
        lambda: gm._gmm_swiglu(x, wg, wu, te, bm, gate_up=True),
        lambda: gm.gmm_swiglu_plain(x, wg, wu, te, bm, gate_up=True),
        lib_swiglu, 2 * (n_rows * d + 2 * used * d * f + 3 * n_rows * f),
        2 * 2 * n_rows * d * f, err, **layout, writes="h, gate, up")

    # The down gmm and the two dlhs gmms against rhs^T.
    def gmm_case(name, lhs, w, trans, n_in, n_out, lib):
        out = gm._gmm(lhs, w, te, bm, transpose_rhs=trans)
        torch.cuda.synchronize()
        ref = gm.gmm_plain(lhs.float(), w.float(), te, bm,
                           transpose_rhs=trans)
        err = check_rel(f"gmm[{name}]", out, ref, rows, KERNEL_REL_TOL)
        del ref, out
        res["gmm"][name] = timed(
            lambda: gm._gmm(lhs, w, te, bm, transpose_rhs=trans),
            lambda: gm.gmm_plain(lhs, w, te, bm, transpose_rhs=trans), lib,
            2 * (n_rows * n_in + used * n_in * n_out + n_rows * n_out),
            2 * n_rows * n_in * n_out, err, **layout,
            rhs="[E, N, K] read as rhs^T" if trans else "[E, K, N]")

    def lib_loop(lhs, w, trans):
        def run():
            for ex, r0, c in grp:
                lhs[r0:r0 + c] @ (w[ex].t() if trans else w[ex])
        return run

    gmm_case("train", h, wd, False, f, d, lib_loop(h, wd, False))
    gmm_case("dlhs_gate_up", g, wg, True, f, d, lib_loop(g, wg, True))
    gmm_case("dlhs_down", dy, wd, True, d, f, lib_loop(dy, wd, True))

    # tgmm at the gate/up shape (with the negative control) and at the down
    # shape; its library yardstick is one matmul per expert's real rows.
    def lib_tgmm(lhs, dout):
        def run():
            for _, r0, c in grp:
                torch.matmul(lhs[r0:r0 + c].t(), dout[r0:r0 + c])
        return run

    for name, lhs, dout, k_, n_ in (("gate_up", x, g, d, f),
                                    ("down", h, dy, f, d)):
        out, chk = tgmm_check(f"tgmm[{name}]", lhs, dout, te, e, bm,
                              control=name == "gate_up")
        del out
        res["tgmm"][name] = timed(
            lambda: gm.tgmm(lhs, dout, te, e, bm),
            lambda: gm.tgmm_plain(lhs, dout, te, e, bm), lib_tgmm(lhs, dout),
            2 * (n_rows * k_ + n_rows * n_ + e * k_ * n_),
            2 * n_rows * k_ * n_, chk["max_abs_err"], **layout,
            max_expert_rel=chk["max_expert_rel"],
            control_rel=chk.get("control", {}).get("rel"))
    del h, g, dy

    # An expert that no token picks: its block must be exactly zero.
    lay0, counts0 = routed_layout(cfg, n_tok, gen, dev, empty=3)
    assert counts0[3] == 0
    x0, g0 = rnd(lay0.m, d), rnd(lay0.m, f)
    out, chk = tgmm_check("tgmm[gate_up, expert 3 unrouted]", x0, g0,
                          lay0.tile_experts, e, lay0.bm, empty=(3,))
    res["tgmm"]["empty_expert"] = {
        "max_expert_rel": chk["max_expert_rel"],
        "exact_zero": chk["empty_experts_exact_zero"][3]}
    del out, x0, g0

    # The compute skip on a worst-case per-shard layout: 2 local experts
    # plus the sentinel group, about half the tiles real.
    skip_case(res, "skip", *shard_layout(n_tok * cfg.moe_top_k, 2, gen, dev),
              wg, gen)
    # The layouts the mesh MoE step builds (models/moe.py: grouped_layout
    # with a local expert range), from a router's top-2 over B x T tokens:
    # ep 1 (8 local experts, the one-card mesh) and ep 4's first shard (2).
    logits = torch.randn((batch, seq_len, e), generator=gen, device=dev)
    _, idx = moe.router_topk(logits, cfg.moe_top_k)
    for ep in (1, 4):
        lay = moe.grouped_layout(idx, e // ep, 256, first_expert=0)
        counts = np.bincount(idx.reshape(-1).cpu().numpy(), minlength=e)
        skip_case(res, f"skip_ep{ep}", lay.tile_experts, lay.valid_tiles,
                  lay.m, lay.bm, counts[:e // ep], wg, gen)
    for name, recs in res.items():
        for shape, rec in recs.items():
            if "ms" in rec:
                print_times(name, shape, rec)
    del x, wg, wu, wd
    gc.collect()
    torch.cuda.empty_cache()
    return res


def skip_case(res, name, te, vt, m, bm, counts, w_all, gen):
    """``gmm`` (the gate product) and ``tgmm`` (its weight gradient) under
    ``valid_tiles`` ``vt`` on a per-shard layout of ``m`` rows whose local
    experts hold ``counts`` rows: rows past ``valid_tiles`` exactly 0, the
    rest within 2e-2 of the plain version, ``tgmm`` per expert as
    ``tgmm_check``; timed beside the plain versions, a per-expert
    ``torch.matmul`` loop over the real rows and the bound over them.
    Adds ``res["gmm"][name]`` and ``res["tgmm"][name]``."""
    dev = te.device
    n_local = len(counts)
    d, f = w_all.shape[1:]
    n_real = int(vt.item())
    rows_l = int(counts.sum())
    skip = {"M": m, "bm": bm, "tiles": m // bm, "valid_tiles": n_real,
            "local_experts": n_local, "local_rows": rows_l}
    print(f"{name} layout: " + json.dumps(skip), flush=True)
    xs = (torch.randn((m, d), generator=gen, device=dev)).to(torch.bfloat16)
    gs = (torch.randn((m, f), generator=gen, device=dev)).to(torch.bfloat16)
    w = w_all[:n_local]
    ys = gm.gmm(xs, w, te, bm, vt)
    torch.cuda.synchronize()
    skipped_zero = not ys[n_real * bm:].any().item()
    ref = gm.gmm_plain(xs.float(), w.float(), te, bm, vt)
    err = check_rel(f"gmm[{name}]", ys, ref,
                    torch.arange(n_real * bm, device=dev), KERNEL_REL_TOL)
    print(f"  gmm[{name}]: rows past valid_tiles exactly 0: {skipped_zero}",
          flush=True)
    assert skipped_zero, "gmm wrote nonzero rows past valid_tiles"
    del ys, ref
    grp = groups(counts, bm)
    res["gmm"][name] = timed(
        lambda: gm.gmm(xs, w, te, bm, vt),
        lambda: gm.gmm_plain(xs, w, te, bm, vt),
        lambda: [xs[r0:r0 + c] @ w[ex] for ex, r0, c in grp],
        2 * (rows_l * d + n_local * d * f + rows_l * f), 2 * rows_l * d * f,
        err, **skip, rows_past_valid_tiles_zero=skipped_zero)
    out, chk = tgmm_check(f"tgmm[{name}]", xs, gs, te, n_local, bm, vt)
    del out
    res["tgmm"][name] = timed(
        lambda: gm.tgmm(xs, gs, te, n_local, bm, vt),
        lambda: gm.tgmm_plain(xs, gs, te, n_local, bm, vt),
        lambda: [torch.matmul(xs[r0:r0 + c].t(), gs[r0:r0 + c])
                 for _, r0, c in grp],
        2 * (rows_l * d + rows_l * f + n_local * d * f), 2 * rows_l * d * f,
        chk["max_abs_err"], **skip, max_expert_rel=chk["max_expert_rel"])
    for kernel in ("gmm", "tgmm"):
        print_times(kernel, name, res[kernel][name])
    del xs, gs


# ---------------------------------------------------------------------------
# Phase 4: flash attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_bounds(b, h, t, d):
    """(bytes, FLOPs) each kernel must move and do at least, causal: each
    input read once, each output written once; the products over the
    t(t+1)/2 visible (query, key) pairs."""
    pairs = b * h * t * (t + 1) / 2
    tile = b * h * t * d * 2            # one bf16 [B, T, H, D] tensor
    row = b * h * t * 4                 # one f32 [B*H, T] statistic
    return {"flash_fwd": (4 * tile + row, 2 * 2 * d * pairs),
            "flash_dq": (5 * tile + 2 * row, 3 * 2 * d * pairs),
            "flash_dkv": (6 * tile + 2 * row, 4 * 2 * d * pairs)}


def flash_run(q, k, v, do, causal=True):
    """The three kernels as the backward chains them."""
    o, lse = at.flash_fwd(q, k, v, causal)
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float()).reshape(
        -1, q.shape[1]).contiguous()
    dq = at.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = at.flash_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    return {"o": o, "lse": lse, "delta": delta, "dq": dq, "dk": dk, "dv": dv}


def row_rel_err(got, ref):
    """Per row (the last axis is head_dim): ||got - ref|| / ||ref||, the
    denominator floored at ``ROW_FLOOR`` x the RMS row norm of ``ref``."""
    got, ref = got.float(), ref.float()
    norm = ref.norm(dim=-1)
    floor = ROW_FLOOR * norm.square().mean().sqrt()
    return (got - ref).norm(dim=-1) / torch.maximum(norm, floor)


def whole_rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over the whole tensor."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def negative_controls(got, ref):
    """The check's readings on deliberately wrong outputs made from the
    kernels' own: dk and dv with every key row from 1500 on zeroed, o with
    every query row from 1024 on scaled by 0.7, dq with every query row from
    2048 on scaled by 0.97.  Each must fail."""
    faults = {}
    for key in ("dk", "dv"):
        bad = got[key].clone()
        bad[:, 1500:] = 0
        faults[f"{key} rows >= 1500 zeroed"] = (bad, ref[key])
    bad = got["o"].clone()
    bad[:, 1024:] *= 0.7
    faults["o rows >= 1024 x 0.7"] = (bad, ref["o"])
    bad = got["dq"].clone()
    bad[:, 2048:] *= 0.97
    faults["dq rows >= 2048 x 0.97"] = (bad, ref["dq"])
    readings = {name: {"max_row_rel": row_rel_err(g, r).max().item(),
                       "whole_tensor_rel": whole_rel_err(g, r)}
                for name, (g, r) in faults.items()}
    print("  negative controls (must fail): " + json.dumps(readings),
          flush=True)
    for name, reading in readings.items():
        assert reading["max_row_rel"] > FLASH_ROW_TOL, (
            f"the flash check passed a wrong output: {name}")


def flash_check(name, q, k, v, do, causal=True, chunk=8, controls=False):
    """Kernels against plain versions on the same inputs (lse and delta
    are the kernels', as in training), ``chunk`` heads at a time to bound
    the plain versions' f32 [B, H, T, T] scores.  Every query row of o and
    dq and every key row of dk and dv must agree within ``FLASH_ROW_TOL``
    (:func:`row_rel_err`).  Returns (max abs errors, max row errors)."""
    b, _, h, _ = q.shape
    out = flash_run(q, k, v, do, causal)
    err = {key: 0.0 for key in ("lse", *FLASH_OUTS)}
    rel = {key: 0.0 for key in FLASH_OUTS}
    worst = {}
    for bi in range(b):
        for h0 in range(0, h, chunk):
            sl = (slice(bi, bi + 1), slice(None), slice(h0, h0 + chunk))
            rows = slice(bi * h + h0, bi * h + min(h0 + chunk, h))
            qs, ks, vs, dos = (x[sl] for x in (q, k, v, do))
            lse, delta = out["lse"][rows], out["delta"][rows]
            o_p, lse_p = at.flash_fwd_plain(qs, ks, vs, causal)
            ref = {"o": o_p, "lse": lse_p,
                   "dq": at.flash_dq_plain(qs, ks, vs, dos, lse, delta,
                                           causal)}
            ref["dk"], ref["dv"] = at.flash_dkv_plain(qs, ks, vs, dos, lse,
                                                      delta, causal)
            got = {key: out[key][rows] if key == "lse" else out[key][sl]
                   for key in ref}
            for key, r in ref.items():
                g = got[key]
                assert torch.isfinite(g).all(), f"{name}: {key} not finite"
                err[key] = max(err[key],
                               (g.float() - r.float()).abs().max().item())
                if key == "lse":
                    continue
                rr = row_rel_err(g, r)              # [1, T, heads]
                i = int(rr.argmax())
                if rr.flatten()[i].item() > rel[key]:
                    rel[key] = rr.flatten()[i].item()
                    worst[key] = {"b": bi, "t": i // rr.shape[2],
                                  "h": h0 + i % rr.shape[2]}
            if controls and bi == 0 and h0 == 0:
                negative_controls(got, ref)
    print(f"  {name}: " + json.dumps({
        "max_row_rel": rel, "worst_row": worst, "max_abs_err": err,
        "tol": {"row_rel": FLASH_ROW_TOL, "row_floor": ROW_FLOOR,
                "lse_abs": LSE_ATOL}}), flush=True)
    for key in FLASH_OUTS:
        assert rel[key] <= FLASH_ROW_TOL, f"{name}: {key} disagrees"
    assert err["lse"] <= LSE_ATOL, f"{name}: lse disagrees"
    return err, rel


def many_heads_check(rnd):
    """The three kernels at B * H past 65535 (``MANY_HEADS``): batches
    ``MANY_HEADS_SLICES`` run alone through the kernels (dq and dkv with the
    full run's lse and delta) must give bit-identical o, lse, dq, dk and dv
    (a head's work does not depend on the grid), and the last two agree
    with the plain versions within ``FLASH_ROW_TOL`` (:func:`flash_check`)."""
    b, t, h, d = MANY_HEADS
    q, k, v, do = (rnd(b, t, h, d) for _ in range(4))
    full = flash_run(q, k, v, do)
    identical = {}
    for bi in MANY_HEADS_SLICES:
        sl, rows = slice(bi, bi + 1), slice(bi * h, (bi + 1) * h)
        qs, ks, vs, dos = (x[sl] for x in (q, k, v, do))
        lse, delta = full["lse"][rows], full["delta"][rows]
        alone = dict(zip(("o", "lse"), at.flash_fwd(qs, ks, vs)))
        alone["dq"] = at.flash_dq(qs, ks, vs, dos, lse, delta)
        alone["dk"], alone["dv"] = at.flash_dkv(qs, ks, vs, dos, lse, delta)
        torch.cuda.synchronize()
        identical[bi] = {
            key: torch.equal(val, full[key][rows if key == "lse" else sl])
            for key, val in alone.items()}
    rel = {bi: flash_check(f"flash[B{b} H{h}, batch {bi} alone]",
                           *(x[bi:bi + 1] for x in (q, k, v, do)))[1]
           for bi in MANY_HEADS_SLICES[1:]}
    out = {"shape": f"B{b} T{t} H{h} D{d} causal", "heads": b * h,
           "bit_identical_alone": identical, "max_row_rel": rel}
    print("  flash[B*H past 65535]: " + json.dumps(out), flush=True)
    assert all(all(x.values()) for x in identical.values()), (
        "a batch run alone differs from the same batch in the full grid")
    del q, k, v, do, full
    torch.cuda.empty_cache()
    return out


def fwd_bwd(attn, q, k, v, do):
    """One forward and backward of ``attn`` (gradients to q, k, v)."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def run():
        out = attn(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do)
    return run


def flash_phase(dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(b, t, h, d):
        return torch.randn((b, t, h, d), generator=gen, device=dev).to(
            torch.bfloat16)

    b, t, h, d = FLASH_SHAPE
    q, k, v, do = (rnd(b, t, h, d) for _ in range(4))
    print(f"flash: B={b} T={t} H={h} D={d} causal bf16", flush=True)
    err, rel = flash_check("flash[pretrain]", q, k, v, do, chunk=PLAIN_HEADS,
                           controls=True)
    # Small shapes: non-causal, head_dim 64, and T = 64 (mod 128), where the
    # last 128-row q block and 128-key K/V stage run past T.
    for name, shape, causal in (("flash[full,d128]", (1, 512, 2, 128), False),
                                ("flash[causal,d64]", (1, 512, 4, 64), True),
                                ("flash[causal,d128,T320]", (2, 320, 2, 128),
                                 True),
                                ("flash[full,d64,T192]", (1, 192, 3, 64),
                                 False)):
        flash_check(name, *(rnd(*shape) for _ in range(4)), causal=causal)

    out = flash_run(q, k, v, do)
    lse, delta = out["lse"], out["delta"]
    del out
    kernel_fns = {
        "flash_fwd": lambda: at.flash_fwd(q, k, v),
        "flash_dq": lambda: at.flash_dq(q, k, v, do, lse, delta),
        "flash_dkv": lambda: at.flash_dkv(q, k, v, do, lse, delta),
    }
    ms = {name: time_ms(fn, 10) for name, fn in kernel_fns.items()}

    # The plain versions on the same inputs, PLAIN_HEADS heads a call.
    parts = [(*(x[bi:bi + 1, :, h0:h0 + PLAIN_HEADS] for x in (q, k, v, do)),
              lse[bi * h + h0:bi * h + h0 + PLAIN_HEADS],
              delta[bi * h + h0:bi * h + h0 + PLAIN_HEADS])
             for bi in range(b) for h0 in range(0, h, PLAIN_HEADS)]

    def plain_over_parts(fn, n_args):
        def run():
            for part in parts:
                fn(*part[:n_args])
        return run

    plain_ms = {name: time_ms(plain_over_parts(fn, n), 2, warmup=1)
                for name, fn, n in (("flash_fwd", at.flash_fwd_plain, 3),
                                    ("flash_dq", at.flash_dq_plain, 6),
                                    ("flash_dkv", at.flash_dkv_plain, 6))}

    # Library yardstick: SDPA on contiguous [B, H, T, D] copies (its own
    # layout): fwd, bwd alone (one call gives dq, dk and dv), fwd+bwd.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))

    def sdpa(a, bb, c):
        return torch.nn.functional.scaled_dot_product_attention(
            a, bb, c, is_causal=True)

    sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o_sdpa = sdpa(qg, kg, vg)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o_sdpa, (qg, kg, vg), dot, retain_graph=True), 10)
    del o_sdpa, qg, kg, vg
    sdpa_fwd_bwd = time_ms(fwd_bwd(sdpa, qt, kt, vt, dot), 5)
    flash_fwd_bwd = time_ms(fwd_bwd(at.flash_attention, q, k, v, do), 5)
    # The backward wrapper's delta = rowsum(dO * O), a plain f32 einsum
    # (ops/attention.py), on the same inputs; its bound reads dO and O once
    # and writes delta once.
    o = at.flash_fwd(q, k, v)[0]
    delta_ms = time_ms(lambda: torch.einsum(
        "bthd,bthd->bht", do.float(), o.float()).reshape(b * h, t)
        .contiguous(), 10)
    delta_bound_ms = bound(2 * b * t * h * d * 2 + b * h * t * 4,
                           2 * b * t * h * d)[0]
    del o

    bounds = flash_bounds(b, h, t, d)
    results = {}
    for name in FLASH_KERNELS:
        b_ms, b_by = bound(*bounds[name])
        keys = {"flash_fwd": ("o",), "flash_dq": ("dq",),
                "flash_dkv": ("dk", "dv")}[name]
        results[name] = {
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sdpa_fwd if name == "flash_fwd" else None,
            "variant": "wgmma",
            "max_abs_err": max(err[key] for key in keys),
            "max_row_rel_err": max(rel[key] for key in keys),
            "shape": f"B{b} T{t} H{h} D{d} causal",
            "plain_calls": f"{len(parts)} x B1 H{PLAIN_HEADS}",
            "GFLOP": bounds[name][1] / 1e9,
        }
        print(f"  {name}: {ms[name]:.4f} ms kernel ({bounds[name][1] / 1e9:.1f}"
              f" GFLOP, bound {b_ms:.4f} ms by {b_by}), {plain_ms[name]:.4f} "
              f"ms plain ({len(parts)} calls)", flush=True)
    for name in ("flash_dq", "flash_dkv"):
        results[name]["sdpa_bwd_dq_dk_dv_ms"] = sdpa_bwd
    sdpa_line = {"sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
                 "flash_dq_plus_dkv_ms": ms["flash_dq"] + ms["flash_dkv"],
                 "delta_einsum_ms": delta_ms,
                 "delta_bound_ms": delta_bound_ms,
                 "sdpa_fwd_bwd_ms": sdpa_fwd_bwd,
                 "flash_fwd_bwd_ms": flash_fwd_bwd}
    print("  library (SDPA, timed only) beside the kernels: "
          + json.dumps(sdpa_line), flush=True)
    for name in ("flash_dq", "flash_dkv"):
        results[name]["delta_einsum_ms"] = delta_ms
    del q, k, v, do, qt, kt, vt, dot, parts, lse, delta
    torch.cuda.empty_cache()
    many = many_heads_check(rnd)
    for name in FLASH_KERNELS:
        results[name]["heads_past_65535"] = many

    # Kernel fwd+bwd against the plain attention path (attention_reference
    # under autograd, what the model runs below the "auto" gate), in turns.
    sweep = []
    for t_ in SWEEP_T:
        q, k, v, do = (rnd(1, t_, h, d) for _ in range(4))
        plain = fwd_bwd(attention_reference, q, k, v, do)
        kern = fwd_bwd(at.flash_attention, q, k, v, do)
        p1, k1, k2, p2 = (time_ms(plain, 3), time_ms(kern, 5),
                          time_ms(kern, 5), time_ms(plain, 3))
        sweep.append({"T": t_, "kernel_ms": (k1 + k2) / 2,
                      "plain_ms": (p1 + p2) / 2, "turns": [p1, k1, k2, p2]})
        del q, k, v, do
        torch.cuda.empty_cache()
    print(f"  fwd+bwd sweep (B1 H{h} D{d} causal): " + json.dumps(sweep),
          flush=True)
    return results


# ---------------------------------------------------------------------------
# Phase 5: serve through the replica
# ---------------------------------------------------------------------------

SERVE_CONFIG = ServeConfig(slots=8, page_size=16, max_len=256,
                           prefill_buckets=(16, 32, 64, 128))


def serve_requests(cfg: LlamaConfig, seed: int):
    """The serve phase's 8 requests (12-120 prompt tokens) from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = [120, 12] + [int(n) for n in rng.integers(12, 121, 6)]
    return [Request(id=f"r{i}",
                    tokens=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=16) for i, n in enumerate(lens)]


def prefill_logits(model, cfg: LlamaConfig, prompt, dev,
                   page_size: int = SERVE_CONFIG.page_size) -> torch.Tensor:
    """The last-position logits of one paged prefill of the first 100
    tokens of ``prompt`` in the 128-token bucket, on a fresh cache."""
    plen, bucket = 100, 128
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt[:plen], device=dev)
    rows = torch.zeros(bucket, dtype=torch.long, device=dev)
    rows[:plen] = page_size + torch.arange(plen, device=dev)
    cache = init_paged_cache(cfg, 1 + bucket // page_size, page_size, dev)
    return paged_prefill(model, toks, cache, rows, plen, cfg)[0]


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def ffn_layer_inputs(model, cfg: LlamaConfig, prompt, dev):
    """The plain path's prefill (``prefill_logits`` with the grouped
    kernels swapped for their plain versions): the expert FFN's arguments
    in each layer, and the logits."""
    calls = []
    real = llama_mod.moe_ffn

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    with plain_grouped_kernels(), mock.patch.object(llama_mod, "moe_ffn",
                                                    record):
        logits = prefill_logits(model, cfg, prompt, dev)
    return calls, logits


@torch.no_grad()
def layer_rel_errs(calls, form_a, form_b):
    """Per recorded layer: max |ffn_a - ffn_b| / max |ffn_b| of the expert
    FFN (``moe.moe_ffn``, the grouped path) on that layer's input, each side
    run under its context manager factory ``form_*``."""
    errs = []
    for args, kwargs in calls:
        with form_a():
            ya = moe.moe_ffn(*args, **kwargs)
        with form_b():
            yb = moe.moe_ffn(*args, **kwargs)
        assert torch.isfinite(ya).all(), "non-finite expert FFN output"
        errs.append(rel_max(ya, yb))
    return errs


@contextmanager
def expert_rows_zeroed():
    """The negative control of the per-layer check: the kernels, with the
    rows of the expert owning tile 0 zeroed in the down gmm's output."""
    real = gm._gmm

    def zeroed(lhs, rhs, te, bm, valid_tiles=None, transpose_rhs=False):
        out = real(lhs, rhs, te, bm, valid_tiles, transpose_rhs)
        rows = (te == te[0]).repeat_interleave(bm)
        return out.masked_fill(rows[:, None], 0)

    with mock.patch.object(gm, "_gmm", zeroed):
        yield


def serve_phase(cfg: LlamaConfig, dev, seed: int):
    scfg = SERVE_CONFIG
    backend = LlamaBackend(cfg, seed=seed, device=dev)
    reqs = serve_requests(cfg, seed)
    lens = [len(r.tokens) for r in reqs]

    torch.cuda.reset_peak_memory_stats()
    for fn in (gm.gmm, gm.gmm_swiglu):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
    t0 = time.perf_counter()
    engine = ServeEngine(backend, scfg)
    engine.start()
    assert engine.wait_ready(900), "engine never became ready"
    t_ready = time.perf_counter()
    for r in reqs:
        assert engine.submit(r), r.id
    for r in reqs:
        assert r.done.wait(900), f"{r.id} never finished"
    t_done = time.perf_counter()
    engine.drain()
    assert engine._drained.wait(60)
    st = engine.stats()
    engine.stop()
    launches = {"gmm": gm.gmm.launches, "gmm_swiglu": gm.gmm_swiglu.launches}
    by_design = {"gmm": dict(gm.gmm.launches_by_design),
                 "gmm_swiglu": dict(gm.gmm_swiglu.launches_by_design)}

    for r in reqs:
        assert not r.error, (r.id, r.error)
        assert len(r.output) == 16, (r.id, len(r.output))
        assert all(0 <= t < cfg.vocab_size for t in r.output), r.id
    assert launches["gmm"] > 0 and launches["gmm_swiglu"] > 0, launches
    # Decode and the 16-token bucket (bm 16, 32) run the swap-AB design,
    # the 32-128-token buckets (bm >= 64) the wgmma one: both must launch.
    assert all(n > 0 for d in by_design.values() for n in d.values()), (
        by_design)
    n_out = sum(len(r.output) for r in reqs)
    out = {
        "load_and_warmup_s": t_ready - t0,
        "ttft_p50_ms": statistics.median(r.ttft_s for r in reqs) * 1e3,
        "decode_ms_per_step_p50": st.itl_ms,
        "tokens_per_s": n_out / (t_done - t_ready),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_steps": st.step, "prefill_buckets_seen": st.prefill_compiles,
        "prompt_lens": lens, "launches_by_design": by_design,
    }
    print("serve: " + json.dumps(out), flush=True)

    # One prefill, layer by layer: each layer's expert FFN through the
    # kernels and through the plain versions, on the plain path's input.
    calls, lp = ffn_layer_inputs(backend.model, cfg, reqs[0].tokens, dev)
    assert len(calls) == cfg.n_layers, len(calls)
    per_layer = layer_rel_errs(calls, contextlib.nullcontext,
                               plain_grouped_kernels)
    control = layer_rel_errs(calls[:1], expert_rows_zeroed,
                             plain_grouped_kernels)[0]
    lk = prefill_logits(backend.model, cfg, reqs[0].tokens, dev)
    assert lk.shape == (cfg.vocab_size,) and torch.isfinite(lk).all()
    out_l = {"per_layer_rel": per_layer, "tol": LAYER_REL_TOL,
             "control_rel": control,
             "logits_rel_8_layers": rel_max(lk, lp),
             "argmax_equal": bool(lk.argmax() == lp.argmax())}
    print("prefill expert FFN kernel vs plain, per layer: "
          + json.dumps(out_l), flush=True)
    assert max(per_layer) <= LAYER_REL_TOL, "a layer's expert FFN disagrees"
    assert control > LAYER_REL_TOL, (
        "the per-layer check passed an FFN output with an expert's rows "
        "zeroed")
    return launches, by_design, backend, scfg


# ---------------------------------------------------------------------------
# Phase 6: where a decode step's and a prefill's device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (
    # flash_fwd_wgmma_kernel<D>, flash_dq_wgmma_kernel<D> and
    # flash_dkv_wgmma_kernel<D>.
    ("flash_fwd", lambda n: re.search(r"\bflash_fwd_(wgmma_)?kernel", n)
     is not None),
    ("flash_dq", lambda n: re.search(r"\bflash_dq_(wgmma_)?kernel", n)
     is not None),
    ("flash_dkv", lambda n: re.search(r"\bflash_dkv_(wgmma_)?kernel", n)
     is not None),
    # tgmm_kernel (WMMA) and tgmm_wgmma_kernel; gmm_swapab_kernel<NR,
    # SWIGLU, TRANS> (bm < 64, gmm_swiglu when SWIGLU),
    # gmm_swiglu_wgmma_kernel<NC> and gmm_wgmma_kernel<NC, TRANS>.
    ("tgmm", lambda n: re.search(r"\btgmm_(wgmma_)?kernel", n) is not None),
    ("gmm_swiglu", lambda n: re.search(
        r"\bgmm_swapab_kernel<\d+, true|\bgmm_swiglu_wgmma_kernel",
        n) is not None),
    ("gmm", lambda n: re.search(r"\bgmm_(wgmma_|swapab_)?kernel", n)
     is not None),
    ("library gemm", lambda n: any(w in n for w in (
        "gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_"))),
    ("gather/scatter", lambda n: any(w in n for w in ("index", "gather",
                                                       "scatter"))),
    ("softmax/reduce", lambda n: "softmax" in n or "reduce" in n.lower()),
    ("optimizer (foreach)", lambda n: "multi_tensor" in n
     or "foreach" in n.lower()),
    ("elementwise/copy", lambda n: True),
)


def profile_calls(name, fn, n):
    """torch.profiler over ``n`` calls of ``fn`` (after one unprofiled
    call): wall ms per call, device-busy ms (the sum of kernel times on the
    one stream), the idle share, and kernel time by group; printed and
    returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # Device events, without the GPU spans of user annotations (AdamW's
    # "Optimizer.step#AdamW.step"), which would count its kernels twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_group = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for e in kernels:
        group = next(g for g, match in KERNEL_GROUPS if match(e.key))
        by_group[group] += e.self_device_time_total / 1e3 / n
    busy_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"calls": n, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms if kernels else None,
           "kernel_launches": sum(e.count for e in kernels) / n,
           "ms_by_group": by_group,
           "top": [[e.key[:90], e.count // n,
                    e.self_device_time_total / 1e3 / n] for e in top]}
    print(f"profile[{name}]: " + json.dumps(rec), flush=True)
    return rec


def touched_experts(fn):
    """The number of experts each layer's routing picks in one call of
    ``fn`` (the grouped path's ``moe.grouped_layout`` calls, in order)."""
    seen = []
    real = moe.grouped_layout

    def spy(idx, *args, **kwargs):
        seen.append(int(torch.unique(idx).numel()))
        return real(idx, *args, **kwargs)

    with mock.patch.object(moe, "grouped_layout", spy):
        fn()
    return seen


def profile_phase(backend, scfg, steps: int = 5):
    """Decode steps of the full slot batch (every slot live at position
    100) and prefills of one 128-token prompt, through the backend the
    engine served with.  Beside each, the experts every layer touches in
    one unprofiled call on the same inputs, and the time their gate, up
    and down weights take to read once at ``PEAK_HBM_BYTES``: the floor
    of the call's ``gmm`` + ``gmm_swiglu`` time."""
    ps, pps = scfg.page_size, scfg.pages_per_slot()
    tables = (1 + np.arange(scfg.slots)[:, None] * pps
              + np.arange(pps)[None, :]).astype(np.int32)
    tokens = np.arange(1, scfg.slots + 1, dtype=np.int32)
    positions = np.full(scfg.slots, 100, np.int32)
    prompt = np.arange(1, 129, dtype=np.int32)[None]
    rows = (tables[0, np.arange(128) // ps] * ps
            + np.arange(128) % ps).astype(np.int32)
    cfg = backend.cfg
    expert_bytes = 3 * cfg.dim * cfg.intermediate * 2
    for name, fn, n in (
            ("decode", lambda: backend.decode(tokens, positions, tables),
             steps),
            ("prefill", lambda: backend.prefill(prompt, rows, 128), 2)):
        touched = touched_experts(fn)
        print(f"profile[{name}] experts touched per layer: " + json.dumps({
            "touched": touched, "weights_read_floor_ms":
                sum(touched) * expert_bytes / PEAK_HBM_BYTES * 1e3}),
              flush=True)
        profile_calls(name, fn, n)


# ---------------------------------------------------------------------------
# Phases 7 and 9: one training step, kernel path against plain path
# ---------------------------------------------------------------------------

@contextmanager
def plain_flash():
    """Route flash attention through the plain versions (comparison only)."""
    with mock.patch.object(at, "flash_fwd", at.flash_fwd_plain), \
            mock.patch.object(at, "flash_dq", at.flash_dq_plain), \
            mock.patch.object(at, "flash_dkv", at.flash_dkv_plain):
        yield


def train_check(label: str, cfg: LlamaConfig, dev, seed: int, plain,
                counters, batch: int = 1, seq_len: int = CHECK_SEQ):
    """One loss and backward of ``cfg`` through the kernels and again with
    ``plain()`` swapping them for their plain versions, from one init and
    one batch: the loss within ``TRAIN_LOSS_RTOL`` relative, every
    parameter gradient within ``TRAIN_GRAD_RTOL`` relative norm.  The
    launch ``counters`` must move on the kernel side and stay on the
    plain side."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev, requires_grad=True)
    tokens = synthetic_tokens(seed, batch, seq_len, cfg.vocab_size, dev)
    runs = {}
    for side in ("kernel", "plain"):
        before = [c.launches for c in counters]
        with contextlib.nullcontext() if side == "kernel" else plain():
            loss = llama_loss(model, tokens, cfg)
            loss.backward()
        moved = [c.launches - b for c, b in zip(counters, before)]
        if side == "kernel":
            assert all(moved), f"kernel path not taken: {moved}"
        else:
            assert not any(moved), f"plain path launched kernels: {moved}"
        runs[side] = (loss.item(), {n: p.grad.float().clone()
                                    for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    assert np.isfinite(lk) and np.isfinite(lp)
    rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gp}
    worst = max(rel, key=rel.get)
    out = {"loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err": rel, "tol": {"loss": TRAIN_LOSS_RTOL,
                                        "grad": TRAIN_GRAD_RTOL}}
    print(f"{label} ({cfg.n_layers} layers, B{batch} T{seq_len}) kernel vs "
          f"plain: " + json.dumps(out), flush=True)
    assert abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), "losses disagree"
    assert rel[worst] <= TRAIN_GRAD_RTOL, f"gradient {worst} disagrees"
    del model, runs, gk, gp
    gc.collect()
    torch.cuda.empty_cache()


@contextmanager
def plain_grouped_kernels():
    """Route the grouped-matmul kernels, forward and backward, through their
    plain versions (comparison only)."""
    with mock.patch.object(gm, "_gmm", gm.gmm_plain), \
            mock.patch.object(gm, "_gmm_swiglu", gm.gmm_swiglu_plain), \
            mock.patch.object(gm, "tgmm", gm.tgmm_plain):
        yield


def train_check_phase(dev, seed: int):
    train_check("train check", llama2_7b(n_layers=2), dev, seed, plain_flash,
                (at.flash_fwd,))


def moe_train_check_phase(cfg: LlamaConfig, dev, seed: int,
                          batch: int = MOE_CHECK["batch"],
                          seq_len: int = MOE_CHECK["seq_len"]):
    train_check("moe train check", cfg, dev, seed, plain_grouped_kernels,
                (gm.gmm, gm.gmm_swiglu, gm.tgmm), batch, seq_len)


# ---------------------------------------------------------------------------
# Phases 8 and 10: pretrain steps through the loop llama_pretrain.main runs
# ---------------------------------------------------------------------------

def counter(name: str):
    """The wrapper whose ``launches`` counts kernel ``name``."""
    return getattr(at, name) if name.startswith("flash") else getattr(gm,
                                                                      name)


def train_run(label: str, cfg: LlamaConfig, dev, seed: int, steps: int,
              batch: int, seq_len: int, want: dict):
    """``llama_pretrain.train`` of ``cfg`` for ``steps`` AdamW steps (lr
    3e-4, weight decay 0.1, clip 1.0) with the launch counters of ``want``
    zeroed just before and read just after: each must equal its ``want``.
    Every loss finite, the last below the first.  Then steps ``steps + 1``
    and ``steps + 2`` of the same loop (same optimizer state and tokens),
    the second under the profiler.  Returns the printed record."""
    counters = {name: counter(name) for name in want}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = llama_pretrain.train(cfg, steps=steps, batch_size=batch,
                               seq_len=seq_len, lr=3e-4, device=dev,
                               seed=seed)
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = statistics.median(res.step_s)
    out = {"layers": cfg.n_layers, "batch": batch, "seq_len": seq_len,
           "steps": steps, "losses": res.losses,
           "step_ms": [x * 1e3 for x in res.step_s], "step_ms_p50": p50 * 1e3,
           "tokens_per_s_p50": batch * seq_len / p50,
           "tokens_per_s_run": res.tokens_per_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "params": sum(p.numel() for p in res.model.parameters())}
    print(f"{label}: " + json.dumps(out), flush=True)
    assert launches == want, (launches, want)
    assert all(np.isfinite(x) for x in res.losses), res.losses
    assert res.losses[-1] < res.losses[0], res.losses
    assert peak_gb < 80, f"peak {peak_gb} GB"

    more = iter(range(steps, steps + 2))
    profile_calls(f"{label} step", lambda: res.step(next(more)), 1)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(dev, seed: int, steps: int = 5, batch: int = 4,
                seq_len: int = 4096):
    """The dense Llama-2-7B-width model at 8 layers: flash_fwd twice per
    layer per step (forward and remat recompute), dq and dkv once."""
    cfg = llama2_7b(n_layers=8)
    want = {name: n * cfg.n_layers * steps for name, n in (
        ("flash_fwd", 2), ("flash_dq", 1), ("flash_dkv", 1))}
    return train_run("train", cfg, dev, seed, steps, batch, seq_len, want)


def moe_train_phase(cfg: LlamaConfig, dev, seed: int, steps: int = 5,
                    batch: int = MOE_TRAIN["batch"],
                    seq_len: int = MOE_TRAIN["seq_len"]):
    """The Mixtral-width MoE model: ``MOE_LAUNCHES_PER_LAYER`` launches per
    layer per step of each grouped-matmul and flash kernel."""
    want = {name: n * cfg.n_layers * steps
            for name, n in MOE_LAUNCHES_PER_LAYER.items()}
    return train_run("moe train", cfg, dev, seed, steps, batch, seq_len, want)


# ---------------------------------------------------------------------------
# Phase 11: the named remat policies at full width
# ---------------------------------------------------------------------------

REMAT_STEPS = 3
DENSE_POLICIES = ("full", "dots", "ffn", "gateup", "gateup_attn")
# Launches per layer per step under each policy: what
# tests/test_torch_remat.py holds the port to against the pallas_call
# count of the reference's jax.grad jaxpr.  The flash forward re-runs under
# every policy (its residuals carry no name); under "moe" the fused
# gmm_swiglu re-runs (its gate/up residuals carry none either) and the down
# gmm ("ffn_down") is kept: 1 forward + 3 dlhs.
REMAT_LAUNCHES_PER_LAYER = {
    **{p: {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
       for p in DENSE_POLICIES},
    "moe": {"gmm_swiglu": 2, "gmm": 4, "tgmm": 3, "flash_fwd": 2,
            "flash_dq": 1, "flash_dkv": 1},
}
MESH_LAYERS = 8
MESH_ARGV = ["--preset", "llama2-7b", "--n-layers", str(MESH_LAYERS),
             "--batch-size", "4", "--seq-len", "4096", "--steps",
             str(REMAT_STEPS), "--dp", "1", "--fsdp", "1", "--tp", "1"]
MESH_LOSS_RTOL = 1e-5


def policy_run(policy: str, cfg: LlamaConfig, dev, batch: int,
               seq_len: int, seed: int) -> dict:
    """``REMAT_STEPS`` steps of ``llama_pretrain.train`` under ``policy``,
    the launch counters zeroed before and read after; each must be
    ``REMAT_LAUNCHES_PER_LAYER`` times the layers and steps."""
    cfg = replace(cfg, remat=True, remat_policy=policy)
    per_layer = REMAT_LAUNCHES_PER_LAYER[policy]
    counters = {name: counter(name) for name in per_layer}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = llama_pretrain.train(cfg, steps=REMAT_STEPS, batch_size=batch,
                               seq_len=seq_len, lr=3e-4, device=dev, seed=seed)
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = statistics.median(res.step_s)
    rec = {"policy": policy, "layers": cfg.n_layers, "batch": batch,
           "seq_len": seq_len, "steps": REMAT_STEPS, "losses": res.losses,
           "step_ms": [x * 1e3 for x in res.step_s],
           "step_ms_p50": p50 * 1e3, "tokens_per_s_p50": batch * seq_len / p50,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {k: v / REMAT_STEPS
                                 for k, v in launches.items()}}
    print(f"remat {policy}: " + json.dumps(rec), flush=True)
    want = {name: n * cfg.n_layers * REMAT_STEPS
            for name, n in per_layer.items()}
    assert launches == want, (policy, launches, want)
    assert all(np.isfinite(x) for x in res.losses), res.losses
    assert peak_gb < 80, f"peak {peak_gb} GB"
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def remat_phase(dev, seed: int, moe_full_loss: float) -> dict:
    """Phase 11 (see the docstring): the dense runs from seed 0 (the init
    of ``llama_pretrain.main``, which phase 12 compares with), the MoE one
    from ``seed`` (phase 10's).  Returns each policy's record."""
    recs = {p: policy_run(p, llama2_7b(n_layers=MESH_LAYERS), dev, 4, 4096,
                          0) for p in DENSE_POLICIES}
    recs["moe"] = policy_run("moe", mixtral_8x7b_train(MOE_TRAIN["layers"]),
                             dev, MOE_TRAIN["batch"], MOE_TRAIN["seq_len"],
                             seed)
    first = {p: r["losses"][0] for p, r in recs.items() if p != "moe"}
    print(f"remat: first-step losses {json.dumps(first)}; moe "
          f"{recs['moe']['losses'][0]!r} vs full {moe_full_loss!r}",
          flush=True)
    assert len(set(first.values())) == 1, first
    assert recs["moe"]["losses"][0] == moe_full_loss
    return recs


# ---------------------------------------------------------------------------
# Phase 12: the mesh path on one card
# ---------------------------------------------------------------------------

def main_in_one_rank_group(dev, argv, counters: dict, seed=None):
    """``llama_pretrain.main(argv)`` inside a one-rank nccl group formed by
    ``JobRuntime.join_group``, the launch ``counters`` (name -> (wrapper,
    attribute)) zeroed just before and read just after, ``train`` given
    ``seed`` when set (the init and tokens of a ``train`` call of that
    seed).  Returns (rc, train result, stdout, launches, peak GB, world,
    backend)."""
    import torch.distributed as dist

    runs = []
    real_train = llama_pretrain.train

    def recording(*args, **kwargs):
        if seed is not None:
            kwargs["seed"] = seed
        runs.append(real_train(*args, **kwargs))
        return runs[-1]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = JobRuntime(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0)
    backend = rt.join_group(dev, timeout_s=120)
    buf = io.StringIO()
    try:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        with mock.patch.object(llama_pretrain, "train", recording), \
                contextlib.redirect_stdout(buf):
            rc = llama_pretrain.main(argv)
        launches = {name: getattr(obj, attr)
                    for name, (obj, attr) in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        world = dist.get_world_size()
    finally:
        rt.shutdown()
    out = buf.getvalue()
    [res] = runs
    assert not dist.is_initialized()
    return rc, res, out, launches, peak_gb, world, backend


def mesh_phase(dev, plain: dict) -> dict:
    """Phase 12 (see the docstring): ``llama_pretrain.main`` in a one-rank
    nccl group against ``plain``, phase 11's "full" record.  Returns the
    record with the launches."""
    from torch.distributed.tensor import DTensor

    counters = {name: (counter(name), "launches") for name in FLASH_KERNELS}
    rc, res, out, launches, peak_gb, world, backend = main_in_one_rank_group(
        dev, MESH_ARGV, counters)
    for line in out.splitlines():
        print(f"mesh: {line}", flush=True)
    sharded = all(isinstance(p, DTensor) for p in res.model.parameters())
    p50 = statistics.median(res.step_s) * 1e3
    rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, plain["losses"])]
    rec = {"backend": backend, "world": world, "rc": rc,
           "params_dtensor": sharded, "losses": res.losses,
           "losses_no_mesh": plain["losses"], "loss_rel_diff_max": max(rel),
           "step_ms": [x * 1e3 for x in res.step_s], "step_ms_p50": p50,
           "step_ms_p50_no_mesh": plain["step_ms_p50"],
           "peak_mem_gb": peak_gb, "peak_mem_gb_no_mesh": plain["peak_mem_gb"],
           "launches": launches}
    print("mesh: " + json.dumps(rec), flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    assert rc == 0 and backend == "nccl" and world == 1, (rc, backend)
    assert ("Mesh: {'pp': 1, 'dp': 1, 'fsdp': 1, 'ep': 1, 'sp': 1, 'tp': 1} "
            "over 1 devices") in out, out
    assert sharded
    want = {"flash_fwd": 2 * MESH_LAYERS * REMAT_STEPS,
            "flash_dq": MESH_LAYERS * REMAT_STEPS,
            "flash_dkv": MESH_LAYERS * REMAT_STEPS}
    assert launches == want, (launches, want)
    assert len(rel) == REMAT_STEPS and max(rel) <= MESH_LOSS_RTOL, rel
    assert peak_gb < 80, f"peak {peak_gb} GB"
    return rec


# ---------------------------------------------------------------------------
# Phase 13: MoE under the mesh on one card (the ep-sharded grouped path)
# ---------------------------------------------------------------------------

MESH_MOE_ARGV = ["--preset", "mixtral-8x7b", "--n-layers",
                 str(MOE_TRAIN["layers"]), "--experts", "8", "--top-k", "2",
                 "--moe-dispatch", "grouped", "--ep", "1", "--fsdp", "1",
                 "--tp", "1", "--strict-moe-dispatch", "--batch-size",
                 str(MOE_TRAIN["batch"]), "--seq-len",
                 str(MOE_TRAIN["seq_len"]), "--steps", str(REMAT_STEPS)]
# Launches per layer per step of the mesh MoE step under remat "full":
# the gate, up and down gmm (forward, recompute) and the three dlhs, and
# the three tgmm, every one the skip form; what tests/test_torch_moe_mesh.py
# holds the CPU to against the reference's jaxpr under its mesh.
MESH_MOE_LAUNCHES_PER_LAYER = {"gmm": 9, "gmm_skip": 9, "tgmm": 3,
                               "tgmm_skip": 3, "gmm_swiglu": 0,
                               "flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
MESH_MOE_LOSS_RTOL = 1e-3


def mesh_moe_phase(dev, seed: int, plain: dict) -> dict:
    """Phase 13 (see the docstring): the MoE under a one-rank nccl mesh
    through ``llama_pretrain.main`` against ``plain``, phase 10's
    unsharded grouped run from ``seed``.  Returns the record with the
    launches."""
    counters = {name: (counter(name.replace("_skip", "")),
                       "skip_launches" if name.endswith("_skip")
                       else "launches")
                for name in MESH_MOE_LAUNCHES_PER_LAYER}
    valid = []
    real_layout = moe.grouped_layout

    def layout(*args, **kwargs):
        lay = real_layout(*args, **kwargs)
        valid.append((lay.m, lay.bm, lay.valid_tiles))
        return lay

    with warnings.catch_warnings(record=True) as caught, \
            mock.patch.object(moe, "grouped_layout", layout):
        warnings.simplefilter("always")
        rc, res, out, launches, peak_gb, world, backend = (
            main_in_one_rank_group(dev, MESH_MOE_ARGV, counters, seed))
    fell_back = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    for line in out.splitlines():
        print(f"mesh moe: {line}", flush=True)
    p50 = statistics.median(res.step_s) * 1e3
    rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, plain["losses"])]
    layers = MOE_TRAIN["layers"]
    rec = {"backend": backend, "world": world, "rc": rc,
           "losses": res.losses, "losses_no_mesh": plain["losses"],
           "loss_rel_diff_max": max(rel), "tol": MESH_MOE_LOSS_RTOL,
           "step_ms": [x * 1e3 for x in res.step_s], "step_ms_p50": p50,
           "step_ms_p50_no_mesh": plain["step_ms_p50"],
           "peak_mem_gb": peak_gb, "peak_mem_gb_no_mesh": plain["peak_mem_gb"],
           "launches": launches, "fell_back": fell_back,
           "layout_first_step": [
               {"M": m, "bm": bm, "tiles": m // bm,
                "valid_tiles": None if vt is None else int(vt.item())}
               for m, bm, vt in valid[:layers]]}
    print("mesh moe: " + json.dumps(rec), flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    assert rc == 0 and backend == "nccl" and world == 1, (rc, backend)
    assert ("Mesh: {'pp': 1, 'dp': 1, 'fsdp': 1, 'ep': 1, 'sp': 1, 'tp': 1} "
            "over 1 devices") in out, out
    assert not fell_back, fell_back
    want = {name: n * layers * REMAT_STEPS
            for name, n in MESH_MOE_LAUNCHES_PER_LAYER.items()}
    assert launches == want, (launches, want)
    assert all(vt is not None for _, _, vt in valid), "an unsharded layout"
    assert all(np.isfinite(x) for x in rec["losses"]), rec["losses"]
    assert len(rel) == REMAT_STEPS and max(rel) <= MESH_MOE_LOSS_RTOL, rel
    assert peak_gb < 80, f"peak {peak_gb} GB"
    return rec


def entry_phase():
    """The CLI as a user calls it: no --device, so CUDA by default; dense,
    then MoE (the tiny preset is f32, so einsum as asked)."""
    for argv in (["--preset", "tiny", "--steps", "2"],
                 ["--preset", "tiny", "--experts", "4", "--moe-dispatch",
                  "einsum", "--steps", "2"]):
        t0 = time.perf_counter()
        rc = llama_pretrain.main(argv)
        assert rc == 0, rc
        print(f"entry point: llama_pretrain.main {' '.join(argv)}, rc {rc}, "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def signed_off(out: str):
    """(final loss, eval accuracy) from a workload's sign-off line."""
    line = out.split("Final loss: ")[1].splitlines()[0]
    loss, acc = line.split("; eval accuracy: ")
    return float(loss), float(acc)


def nccl_one_rank_check(dev):
    """One ``make_dist_step`` step with no group, then the same step (same
    init, same batch) in a one-rank nccl group formed by ``JobRuntime``:
    the flat ``all_reduce`` runs once and the parameters, the optimizer's
    moments and the loss come out bit-identical."""
    import torch.distributed as dist

    from kubeflow_controller_tpu_torch.workloads.data import synthetic_mnist
    from kubeflow_controller_tpu_torch.workloads.trainer import (
        default_optimizer,
        make_dist_step,
    )

    x, y = synthetic_mnist(1, 100, dev)

    def one_step():
        model = mnist.MnistMLP(mnist.mlp_init(0), dev)
        opt = default_optimizer(model.parameters(), 5e-3)
        step = make_dist_step(lambda a, b: mnist.mlp_loss(model, a, b), opt)
        loss = step(x[None], y[None], 0)
        return model, opt, loss

    assert not dist.is_initialized()
    plain_model, plain_opt, plain_loss = one_step()
    rt = JobRuntime(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0)
    backend = rt.join_group(dev, timeout_s=120)
    calls = []
    real = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls.append(tensor.numel())
        return real(tensor, *args, **kwargs)

    try:
        with mock.patch.object(dist, "all_reduce", counted):
            model, opt, loss = one_step()
        torch.cuda.synchronize()
        world = dist.get_world_size()
    finally:
        rt.shutdown()
    n_params = sum(p.numel() for p in model.parameters())
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  plain_model.parameters()))
    same_state = all(
        torch.equal(sa[k], sb[k])
        for sa, sb in zip(opt.inner.state.values(),
                          plain_opt.inner.state.values()) for k in sa)
    print(f"dist-mnist nccl: backend {backend}, world {world}, all_reduce "
          f"calls {calls} (grads + loss = {n_params + 1}), params "
          f"bit-identical to no group: {same}, adam state: {same_state}, "
          f"loss {float(loss)!r} vs {float(plain_loss)!r}", flush=True)
    assert backend == "nccl" and world == 1, (backend, world)
    assert calls == [n_params + 1], calls
    assert same and same_state and torch.equal(loss, plain_loss)
    assert not dist.is_initialized()


def mnist_phase(dev):
    """The dist-mnist slice on the card (see phase 15 in the docstring).
    Returns the launch counters across the two entry points (all 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {name: getattr(at, name) for name in FLASH_KERNELS}
    counters.update({name: getattr(gm, name) for name in GROUPED_KERNELS})
    for c in counters.values():
        c.launches = 0
    for name, entry in (("mnist_local", mnist_local.main),
                        ("mnist_dist", mnist_dist.main)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = entry([])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"{name}: {line}", flush=True)
        print(f"{name}: main([]) rc {rc}, {wall:.3f} s wall", flush=True)
        loss, acc = signed_off(out)
        assert rc == 0 and math.isfinite(loss), (rc, loss)
    launches = {name: c.launches for name, c in counters.items()}
    assert not any(launches.values()), launches

    cpu = torch.device("cpu")
    for name, fit in (
            ("mnist_local", lambda d: mnist_local.train(device=d)),
            ("mnist_dist", lambda d: mnist_dist.run_worker(
                mnist_dist.parse_args(["--device", str(d)]))),
            ("mnist_dist --step-loop", lambda d: mnist_dist.run_worker(
                mnist_dist.parse_args(["--device", str(d), "--step-loop"])))):
        t0 = time.perf_counter()
        on_card = fit(dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = fit(cpu)
        cpu_s = time.perf_counter() - t0
        a = on_card.losses.cpu().numpy()
        b = on_cpu.losses.numpy()
        err = float(np.max(np.abs(a - b)))
        print(f"{name}: {len(a)} per-step losses, cuda vs cpu max |diff| "
              f"{err:.3e} (tol {MNIST_LOSS_ATOL:g}); final {float(a[-1])!r} "
              f"vs {float(b[-1])!r}; accuracy {on_card.accuracy!r} vs "
              f"{on_cpu.accuracy!r}; fit {card_s:.3f} s cuda, {cpu_s:.3f} s "
              f"cpu", flush=True)
        assert a.shape == b.shape == (200,) and err <= MNIST_LOSS_ATOL, err
    nccl_one_rank_check(dev)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: checkpoint/resume at Llama-2-7B widths (a child process)
# ---------------------------------------------------------------------------

def resume_phase(dev, seed: int) -> dict:
    """Run in the child (``--resume-phase``): ``llama_pretrain.train`` at
    Llama-2-7B widths, 2 layers (1 if the disk under ``SMOKE_DIR`` cannot
    take two steps), B 1 x T ``CHECK_SEQ`` (so attention "auto" takes the
    flash kernels), deterministic algorithms on: 4 steps uninterrupted;
    then 2 steps with ``checkpoint_every=2`` into a fresh ``MODEL_DIR``
    (an async save of step 2), the model and optimizer dropped, and 2 more
    steps from the restored step 2.  The per-step losses and the final
    parameters must be bit-identical to the uninterrupted run's.  Returns
    the record, with the flash launches of the resumed run."""
    SMOKE_DIR.mkdir(exist_ok=True)
    free = shutil.disk_usage(SMOKE_DIR).free
    layers = 2 if free >= RESUME_DISK_BYTES else 1
    cfg = llama2_7b(n_layers=layers)
    kw = dict(batch_size=1, seq_len=CHECK_SEQ, lr=3e-4, device=dev,
              seed=seed)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        whole = llama_pretrain.train(cfg, steps=4, **kw)
        want_losses = list(whole.losses)
        want = [p.detach().clone() for p in whole.model.parameters()]
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        model_dir = tempfile.mkdtemp(dir=SMOKE_DIR, prefix="resume-")
        try:
            first = llama_pretrain.train(cfg, steps=2, model_dir=model_dir,
                                         checkpoint_every=2, **kw)
            losses = list(first.losses)
            save = first.checkpoint.events[0]
            del first
            gc.collect()
            torch.cuda.empty_cache()
            counters = {name: getattr(at, name) for name in FLASH_KERNELS}
            for c in counters.values():
                c.launches = 0
            second = llama_pretrain.train(cfg, steps=2, model_dir=model_dir,
                                          checkpoint_every=2, **kw)
            launches = {name: c.launches for name, c in counters.items()}
            restore = second.checkpoint.events[0]
            final_save = second.checkpoint.events[-1]
            losses += second.losses
            same = [torch.equal(a, b) for a, b in zip(
                second.model.parameters(), want)]
            start = second.start_step
            del second
        finally:
            shutil.rmtree(model_dir, ignore_errors=True)
    nondeterministic = sorted({str(w.message).split(" does not have")[0]
                               for w in caught
                               if "deterministic" in str(w.message)})
    n = save["bytes"]
    rec = {
        "layers": layers, "disk_free_gb": free / 1e9, "seq_len": CHECK_SEQ,
        "params": sum(p.numel() for p in want), "resumed_from": start,
        "losses_uninterrupted": want_losses, "losses_resumed": losses,
        "losses_bit_identical": losses == want_losses,
        "params_bit_identical": all(same), "params_differing": same.count(
            False),
        "save_bytes": n, "save_blocking_s": save["blocking_s"],
        "save_total_s": save["total_s"], "save_gb_per_s": n / save["total_s"]
        / 1e9, "snapshot_gb_per_s": n / save["blocking_s"] / 1e9,
        "restore_s": restore["seconds"],
        "restore_gb_per_s": restore["bytes"] / restore["seconds"] / 1e9,
        "final_save": final_save, "launches": launches,
        "nondeterministic_ops": nondeterministic}
    print("resume: " + json.dumps(rec), flush=True)
    assert start == 2 and restore["step"] == 2, (start, restore)
    want_launches = {"flash_fwd": 2 * layers * 2, "flash_dq": layers * 2,
                     "flash_dkv": layers * 2}
    assert launches == want_launches, (launches, want_launches)
    assert rec["losses_bit_identical"], (losses, want_losses)
    assert rec["params_bit_identical"], rec["params_differing"]
    return rec


def resume_child(seed: int) -> dict:
    """``resume_phase`` in a child process of this script, with cuBLAS's
    deterministic workspace (``CUBLAS_WORKSPACE_CONFIG`` must be set before
    the first cuBLAS call, which the earlier phases have made here), and
    the node agent's file-drop progress transport (``KCTPU_PROGRESS_DIR``,
    ``KCTPU_POD_NAME``).  The child's last beat must be the resumed run's
    last step: ``phase="fit"`` at step 4, ``resumedFromStep`` 2, and
    ``compileSource`` "cache-hit" (this process built the kernels)."""
    out = SMOKE_DIR / f"resume-{os.getpid()}.json"
    SMOKE_DIR.mkdir(exist_ok=True)
    drop = tempfile.mkdtemp(dir=SMOKE_DIR)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               KCTPU_PROGRESS_DIR=drop, KCTPU_POD_NAMESPACE="default",
               KCTPU_POD_NAME="chip-smoke-resume")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, __file__, "--seed", str(seed),
                              "--resume-phase", str(out)], env=env,
                             timeout=900)
        assert res.returncode == 0, f"resume child exited {res.returncode}"
        with open(os.path.join(drop, progress.drop_filename(
                "default", "chip-smoke-resume"))) as fh:
            last = json.load(fh)
    finally:
        shutil.rmtree(drop, ignore_errors=True)
    rec = json.loads(out.read_text())
    out.unlink()
    rec["last_beat"] = last
    print(f"resume: child process {time.perf_counter() - t0:.3f} s; its "
          f"last beat {json.dumps(last)}", flush=True)
    want = {"phase": "fit", "step": 4, "compileSource": "cache-hit",
            "resumedFromStep": 2}
    assert {k: last.get(k) for k in want} == want, (last, want)
    return rec


# ---------------------------------------------------------------------------
# Phase 17: the vision TFJobs
# ---------------------------------------------------------------------------

def fit_record(res, wall_s: float) -> dict:
    steps = len(res.losses)
    return {"steps": steps, "batch": res.batch_size,
            "losses_first_last": [float(res.losses[0]),
                                  float(res.losses[-1])],
            "accuracy": res.accuracy, "elapsed_s": res.elapsed_s,
            "steps_per_s": steps / res.elapsed_s,
            "images_per_s": steps * res.batch_size / res.elapsed_s,
            "wall_s": wall_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}


def timed_fit(mod, argv):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = mod.run(mod.parse_args(argv))
    return res, fit_record(res, time.perf_counter() - t0)


RESNET50_ARGV = ["--model", "resnet50", "--width", "64"]


def nccl_vision_check(dev):
    """One ResNet-50 step (width 64, batch 32) with no group and again in
    a one-rank nccl group, cuDNN deterministic: the parameters, the
    BatchNorm statistics and the loss come out bit-identical, through one
    collective per BatchNorm forward and backward and the gradients' one
    a step."""
    import torch.distributed as dist

    argv = RESNET50_ARGV + ["--batch-size", "32", "--steps", "1"]
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        plain = cifar_allreduce.run(cifar_allreduce.parse_args(argv))
        rt = JobRuntime(coordinator=f"127.0.0.1:{free_port()}",
                        num_processes=1, process_id=0)
        backend = rt.join_group(dev, timeout_s=120)
        calls, warm = [], []
        real = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            # The fit is one CUDA graph: the collectives it holds are the
            # ones issued while it is captured (the warm-up's run before).
            (calls if torch.cuda.is_current_stream_capturing()
             else warm).append(tensor.numel())
            return real(tensor, *args, **kwargs)

        try:
            with mock.patch.object(dist, "all_reduce", counted):
                grouped = cifar_allreduce.run(
                    cifar_allreduce.parse_args(argv))
            torch.cuda.synchronize()
        finally:
            rt.shutdown()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
    a, b = plain.model.state_dict(), grouped.model.state_dict()
    same = all(torch.equal(a[k], b[k]) for k in a)
    want = 2 * RESNET50_BN_LAYERS + 1
    print(f"vision nccl: backend {backend}, collectives a step {len(calls)} "
          f"in the graph (2 x {RESNET50_BN_LAYERS} BatchNorm + 1 gradient; "
          f"{len(warm)} in the warm-up before the capture), state "
          f"bit-identical to no group: {same}, loss {grouped.loss!r} vs "
          f"{plain.loss!r}", flush=True)
    assert backend == "nccl" and len(calls) == want, (backend, len(calls))
    assert same and grouped.loss == plain.loss
    assert not dist.is_initialized()


def vision_phase(dev):
    """The vision TFJobs on the card (phase 17 in the docstring).  Returns
    the launch counters across them (all 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {name: getattr(at, name) for name in FLASH_KERNELS}
    counters.update({name: getattr(gm, name) for name in GROUPED_KERNELS})
    for c in counters.values():
        c.launches = 0
    for run in ("first", "second"):
        res, rec = timed_fit(cifar_allreduce, RESNET50_ARGV + [
            "--batch-size", "128", "--steps", "20"])
        print(f"vision: cifar_allreduce resnet50 width 64, {run} run: "
              + json.dumps(rec), flush=True)
        assert res.losses.shape == (20,) and torch.isfinite(
            res.losses).all(), res.losses
        del res
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = flax_mnist.main([])
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"flax_mnist: {line}", flush=True)
    loss, acc = signed_off(buf.getvalue())
    print(f"flax_mnist: main([]) rc {rc}, {wall:.3f} s wall", flush=True)
    assert rc == 0 and math.isfinite(loss), (rc, loss)
    _, rec = timed_fit(flax_mnist, [])
    print("vision: flax_mnist defaults: " + json.dumps(rec), flush=True)
    launches = {name: c.launches for name, c in counters.items()}
    assert not any(launches.values()), launches

    for name, mod, argv, tol, rel in (
            ("cifar_allreduce resnet50", cifar_allreduce, RESNET50_ARGV,
             RESNET_LOSS_RTOL, True),
            ("flax_mnist", flax_mnist, [], MNIST_LOSS_ATOL, False)):
        argv = argv + ["--batch-size", "32", "--steps", "3"]
        t0 = time.perf_counter()
        card = mod.run(mod.parse_args(argv)).losses.cpu().numpy()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = mod.run(mod.parse_args(argv + ["--device", "cpu"])).losses
        cpu_s = time.perf_counter() - t0
        cpu = cpu.numpy()
        diff = np.abs(card - cpu) / (np.abs(cpu) if rel else 1.0)
        print(f"vision: {name} 3 steps batch 32, cuda vs cpu per-step "
              f"losses {card.tolist()} vs {cpu.tolist()}, max "
              f"{'relative' if rel else 'absolute'} diff "
              f"{float(diff.max()):.3e} (tol {tol:g}); {card_s:.3f} s cuda, "
              f"{cpu_s:.3f} s cpu", flush=True)
        assert diff.max() <= tol, (name, diff)
    nccl_vision_check(dev)
    return launches


# ---------------------------------------------------------------------------
# Phase 18: sequence parallelism on one card
# ---------------------------------------------------------------------------

SP_SHAPE = (1, 32768, 32, 128)      # Llama-2-7B's attention at T 32768
SP_RINGS = (4, 2)                   # virtual ranks: T_local 8192, 16384
SP_ULYSSES = 4
SP_BLOCK_HEADS = 2                  # plain scores [1, 2, 8192, 8192] f32


def timed_schedule(schedule, segments: list):
    """``schedule`` resumed as it is, with CUDA events around each
    resumption: on one stream they bracket that virtual rank's kernels."""
    value = None
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            out = schedule.send(value)
        except StopIteration as stop:
            end.record()
            segments.append((start, end))
            return stop.value
        end.record()
        segments.append((start, end))
        value = yield out


def shards(x, n):
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def ring_lockstep(parts, n, lse_of=None, timing=None):
    """The causal flash ring over n virtual ranks (``ring.run_lockstep``):
    the merged output, lse and the q/k/v gradients, each rank's shard
    concatenated.  ``lse_of(r, lse)`` replaces the lse rank r's backward
    reads (the control); ``timing`` collects each rank's forward and
    backward event pairs."""
    from kubeflow_controller_tpu_torch.parallel import ring

    scale = SP_SHAPE[3] ** -0.5
    timing = timing if timing is not None else {}
    segs = {(r, d): timing.setdefault((r, d), []) for r in range(n)
            for d in ("fwd", "bwd")}
    fwd = ring.run_lockstep([timed_schedule(ring.ring_flash_forward(
        parts["q"][r], parts["k"][r], parts["v"][r], r, n, True, scale),
        segs[(r, "fwd")]) for r in range(n)])
    bwd = ring.run_lockstep([timed_schedule(ring.ring_flash_backward(
        parts["q"][r], parts["k"][r], parts["v"][r], fwd[r][0],
        lse_of(r, fwd[r][1]) if lse_of else fwd[r][1], parts["do"][r], r, n,
        True, scale), segs[(r, "bwd")]) for r in range(n)])
    torch.cuda.synchronize()
    return {"o": torch.cat([o for o, _ in fwd], dim=1),
            "lse": [lse for _, lse in fwd],
            **{key: torch.cat([g[i] for g in bwd], dim=1)
               for i, key in enumerate(("dq", "dk", "dv"))}}


def sp_row_errs(got, ref):
    """The largest per-row error of o, dq (query rows) and dk, dv (key
    rows) against the one call's (``row_rel_err``)."""
    return {key: row_rel_err(got[key], ref[key]).max().item()
            for key in FLASH_OUTS}


@contextmanager
def plain_versions_raise():
    """The flash kernels' plain versions raise while this is open."""
    def refuse(*args, **kwargs):
        raise AssertionError("a flash plain version ran on the sp path")
    with mock.patch.object(at, "flash_fwd_plain", refuse), \
            mock.patch.object(at, "flash_dq_plain", refuse), \
            mock.patch.object(at, "flash_dkv_plain", refuse):
        yield


def sp_block_check(parts, ring_out, n):
    """The ring's visible-block calls at T_local = T / n, non-causal, on
    ``SP_BLOCK_HEADS`` heads: rank n - 1 holding rank 0's block, with rank
    n - 1's merged lse and delta; each kernel against its plain version,
    row by row, with ms, plain ms, the bound and SDPA's ms (forward; for
    dq and dkv its backward, which makes dq, dk and dv in one call)."""
    h = SP_BLOCK_HEADS
    r = n - 1
    q, do = (parts[x][r][:, :, :h].contiguous() for x in ("q", "do"))
    k, v = (parts[x][0][:, :, :h].contiguous() for x in ("k", "v"))
    o_r = ring_out["o"].chunk(n, dim=1)[r][:, :, :h].float()
    lse = ring_out["lse"][r][:h].contiguous()
    delta = torch.einsum("bthd,bthd->bht", do.float(), o_r).reshape(
        h, -1).contiguous()
    got = dict(zip(("o", "lse"), at.flash_fwd(q, k, v, False)))
    got["dq"] = at.flash_dq(q, k, v, do, lse, delta, False)
    got["dk"], got["dv"] = at.flash_dkv(q, k, v, do, lse, delta, False)
    ref = dict(zip(("o", "lse"), at.flash_fwd_plain(q, k, v, False)))
    ref["dq"] = at.flash_dq_plain(q, k, v, do, lse, delta, False)
    ref["dk"], ref["dv"] = at.flash_dkv_plain(q, k, v, do, lse, delta,
                                              False)
    torch.cuda.synchronize()
    rel = {key: row_rel_err(got[key], ref[key]).max().item()
           for key in FLASH_OUTS}
    err = {key: (got[key].float() - ref[key].float()).abs().max().item()
           for key in ("lse", *FLASH_OUTS)}
    b, t = 1, q.shape[1]
    pairs = b * h * t * t
    tile, row = b * h * t * SP_SHAPE[3] * 2, b * h * t * 4
    work = {"flash_fwd": (4 * tile + row, 2 * 2 * SP_SHAPE[3] * pairs),
            "flash_dq": (5 * tile + 2 * row, 3 * 2 * SP_SHAPE[3] * pairs),
            "flash_dkv": (6 * tile + 2 * row, 4 * 2 * SP_SHAPE[3] * pairs)}
    calls = {
        "flash_fwd": (lambda: at.flash_fwd(q, k, v, False),
                      lambda: at.flash_fwd_plain(q, k, v, False), ("o",)),
        "flash_dq": (lambda: at.flash_dq(q, k, v, do, lse, delta, False),
                     lambda: at.flash_dq_plain(q, k, v, do, lse, delta,
                                               False), ("dq",)),
        "flash_dkv": (lambda: at.flash_dkv(q, k, v, do, lse, delta, False),
                      lambda: at.flash_dkv_plain(q, k, v, do, lse, delta,
                                                 False), ("dk", "dv")),
    }
    # Library yardstick: SDPA's non-causal forward on [B, H, T, D] copies,
    # and its backward alone (one call gives dq, dk and dv: the yardstick
    # of flash_dq and flash_dkv alike, as on the main rows).
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        o_sdpa, (qg, kg, vg), dot, retain_graph=True), 10)
    del o_sdpa, qg, kg, vg
    recs = {}
    for name, (kern, plain, keys) in calls.items():
        b_ms, b_by = bound(*work[name])
        recs[name] = {
            "shape": f"B1 T{t} H{h} D{SP_SHAPE[3]} non-causal, merged lse",
            "ms": time_ms(kern, 10), "plain_ms": time_ms(plain, 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sdpa_ms if name == "flash_fwd" else sdpa_bwd_ms,
            "max_abs_err": max(err[key] for key in keys),
            "max_row_rel_err": max(rel[key] for key in keys)}
    print("  sp block kernels vs plain: " + json.dumps(
        {"max_row_rel": rel, "max_abs_err": err, "times": recs}),
        flush=True)
    for key in FLASH_OUTS:
        assert rel[key] <= FLASH_ROW_TOL, f"sp block: {key} disagrees"
    assert err["lse"] <= LSE_ATOL, "sp block: lse disagrees"
    return recs


def sp_phase(dev, seed: int):
    """Sequence parallelism on one card (phase 18 in the docstring).
    Returns (the launches of each path, the block kernels' records)."""
    from kubeflow_controller_tpu_torch.parallel import ulysses

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t, h, d = SP_SHAPE
    q, k, v, do = (torch.randn(SP_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    ref = flash_run(q, k, v, do)
    one_ms = time_ms(fwd_bwd(at.flash_attention, q, k, v, do), 3)
    print(f"sp: B{b} T{t} H{h} D{d} causal bf16; one flash_attention call "
          f"fwd+bwd {one_ms:.3f} ms", flush=True)
    launches, block = {}, None
    for n in SP_RINGS:
        parts = {name: shards(x, n) for name, x in
                 (("q", q), ("k", k), ("v", v), ("do", do))}
        for name in FLASH_KERNELS:
            counter(name).launches = 0
        with plain_versions_raise():
            got = ring_lockstep(parts, n)
        launches[f"ring_n{n}"] = {name: counter(name).launches
                                  for name in FLASH_KERNELS}
        rel = sp_row_errs(got, ref)
        timing = {}             # a second run, past the first calls' costs
        ring_lockstep(parts, n, timing=timing)
        per_rank = {r: {d: sum(s.elapsed_time(e) for s, e in
                               timing[(r, d)]) for d in ("fwd", "bwd")}
                    for r in range(n)}
        ring_ms = time_ms(lambda: ring_lockstep(parts, n), 2, warmup=1)
        # Control: each rank's backward reads its own diagonal block's lse
        # in place of the ring's merged one.
        own = [at.flash_fwd(parts["q"][r], parts["k"][r], parts["v"][r],
                            True)[1] for r in range(n)]
        bad = sp_row_errs(ring_lockstep(parts, n,
                                        lse_of=lambda r, _: own[r]), ref)
        print(f"  ring n={n} (T_local {t // n}): " + json.dumps({
            "launches": launches[f"ring_n{n}"],
            "want_each": n * (n + 1) // 2, "max_row_rel": rel,
            "tol": FLASH_ROW_TOL,
            "ms_per_virtual_rank": per_rank,
            "critical_path_ms": sum(per_rank[n - 1].values()),
            "lockstep_fwd_bwd_ms": ring_ms, "one_call_fwd_bwd_ms": one_ms,
            "control_own_lse_max_row_rel": bad}), flush=True)
        assert all(c == n * (n + 1) // 2
                   for c in launches[f"ring_n{n}"].values()), launches
        for key in FLASH_OUTS:
            assert rel[key] <= FLASH_ROW_TOL, f"ring n={n}: {key} disagrees"
        assert any(bad[key] > FLASH_ROW_TOL for key in FLASH_OUTS), (
            "the ring check passed the block's own lse")
        if n == SP_RINGS[0]:
            block = sp_block_check(parts, got, n)
        del got, parts
        torch.cuda.empty_cache()

    n = SP_ULYSSES
    leaves = {name: [x.detach().requires_grad_() for x in shards(y, n)]
              for name, y in (("q", q), ("k", k), ("v", v))}
    for name in FLASH_KERNELS:
        counter(name).launches = 0
    with plain_versions_raise():
        outs = ulysses.ulysses_lockstep(leaves["q"], leaves["k"],
                                        leaves["v"], causal=True)
        torch.autograd.backward(outs, shards(do, n))
    torch.cuda.synchronize()
    launches[f"ulysses_n{n}"] = {name: counter(name).launches
                                 for name in FLASH_KERNELS}
    got = {"o": torch.cat(outs, dim=1).detach(),
           **{f"d{x}": torch.cat([y.grad for y in leaves[x]], dim=1)
              for x in "qkv"}}
    same = {key: torch.equal(got[key], ref[key]) for key in FLASH_OUTS}
    rel = sp_row_errs(got, ref)
    print(f"  ulysses n={n} ({h // n} heads a rank over T {t}): "
          + json.dumps({"launches": launches[f"ulysses_n{n}"],
                        "bit_identical_to_one_call": same,
                        "max_row_rel": rel}), flush=True)
    assert all(c == n for c in launches[f"ulysses_n{n}"].values()), launches
    for key in FLASH_OUTS:
        assert rel[key] <= FLASH_ROW_TOL, f"ulysses: {key} disagrees"
    del q, k, v, do, ref, got, outs, leaves
    torch.cuda.empty_cache()
    return launches, block


# ---------------------------------------------------------------------------
# Phase 19: cached generation (forward_with_cache, generate)
# ---------------------------------------------------------------------------

GEN_BATCH = 8
GEN_NEW = 64
GEN_MOE_PROMPT = 512       # S 576, rounded up to 768: 3 blocks
GEN_DENSE_PROMPT = 2048    # S 2112, rounded up to 2304: 9 blocks
GEN_LONG_PROMPT = 4096     # 19b's long prefill: S 4352, 17 blocks
GEN_MESH_LAYERS = 8
# 19b's reads: kv_block 4096 is above the cache's 2112, so S is not a block
# multiple and the dense read runs.
GEN_READS = {"bf16_blocked": (None, False), "bf16_dense": (4096, False),
             "int8_blocked": (None, True), "int8_dense": (4096, True)}


def llama2_7b_decode(n_layers: int = 32) -> LlamaConfig:
    """Llama-2-7B widths with bf16 parameters (≈13.5 GB at 32 layers): a
    decode step reads each weight once, where f32 parameters would be cast
    to bf16 at every use."""
    return replace(LlamaConfig.llama2_7b(), n_layers=n_layers,
                   param_dtype="bfloat16")


@contextmanager
def generate_recorded(rec: dict):
    """Record, while open, every forward of ``generate``: CUDA events and
    host seconds around it (``rec["events"]``, ``rec["host_s"]``), the
    last position's logits it sampled from (``rec["logits"]``) and the
    cache it made (``rec["cache"]``)."""
    real_forward, real_next = gen_mod._forward, gen_mod._next_tokens
    real_init = gen_mod.init_cache
    rec.update(events=[], host_s=[], logits=[])

    def forward(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real_forward(*args, **kwargs)
        end.record()
        rec["host_s"].append(time.perf_counter() - t0)
        rec["events"].append((start, end))
        return out

    def next_tokens(logits, *args, **kwargs):
        rec["logits"].append(logits[:, -1].clone())
        return real_next(logits, *args, **kwargs)

    def init(*args, **kwargs):
        rec["cache"] = real_init(*args, **kwargs)
        return rec["cache"]

    with mock.patch.object(gen_mod, "_forward", forward), \
            mock.patch.object(gen_mod, "_next_tokens", next_tokens), \
            mock.patch.object(gen_mod, "init_cache", init):
        yield rec


def timed_generate(model, prompt, cfg, **kwargs):
    """``generate`` with each forward timed: (tokens, record) where the
    record holds prefill ms, the decode steps' ms and their p50 (CUDA
    events: a step's wall time on the device, host gaps included), the host
    ms a step, the peak GB and the cache's GB."""
    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with generate_recorded(rec):
        out = gen_mod.generate(model, prompt, cfg, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e in rec["events"]]
    cache_gb = sum(t.numel() * t.element_size()
                   for t in rec["cache"].values()) / 1e9
    return out, {
        "prefill_ms": ms[0], "step_ms": ms[1:],
        "ms_per_token_p50": statistics.median(ms[1:]),
        "host_ms_per_token_p50": statistics.median(rec["host_s"][1:]) * 1e3,
        "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "cache_gb": cache_gb, "cache_len": rec["cache"]["k"].shape[2],
        "logits": rec["logits"], "cache": rec["cache"]}


def token_agreement(a: torch.Tensor, b: torch.Tensor, t_p: int) -> dict:
    """How far two generations' new tokens agree: per sequence the new
    tokens before the first difference, and the share of equal ones."""
    na, nb = a[:, t_p:], b[:, t_p:]
    same = na == nb
    lead = [int(row.tolist().index(False)) if not row.all() else row.numel()
            for row in same]
    return {"leading_equal_by_seq": lead,
            "equal_share": same.float().mean().item()}


def decode_profile(name, model, cfg, cache, t_p, kv_block=None):
    """One decode token (position ``t_p + GEN_NEW - 1``, the cache's last
    written row plus one) under the profiler: launches, busy and idle."""
    tok = torch.ones((GEN_BATCH, 1), dtype=torch.long,
                     device=cache["k"].device)
    return profile_calls(name, lambda: gen_mod.forward_with_cache(
        model, tok, cache, t_p + GEN_NEW - 1, cfg, kv_block=kv_block), 1)


@contextmanager
def grouped_plain_raise():
    """The grouped kernels' plain versions raise while this is open."""
    def refuse(*args, **kwargs):
        raise AssertionError("a grouped plain version ran on the generate "
                             "path")
    with mock.patch.object(gm, "gmm_plain", refuse), \
            mock.patch.object(gm, "gmm_swiglu_plain", refuse):
        yield


def zero_counters():
    for name in GROUPED_KERNELS + FLASH_KERNELS:
        c = counter(name)
        c.launches = 0
        if hasattr(c, "launches_by_design"):
            c.launches_by_design = dict.fromkeys(c.launches_by_design, 0)


def read_counters() -> dict:
    return {name: counter(name).launches
            for name in GROUPED_KERNELS + FLASH_KERNELS}


def generate_prefill(model, cfg, prompt, s, ctx, record_calls=False):
    """One prefill of ``prompt`` through ``forward_with_cache`` on a fresh
    cache of length ``s`` under ``ctx()``: (logits, each layer's routing
    [B, T, k], each layer's expert-FFN call when ``record_calls``, the
    call's ms by CUDA events)."""
    calls, routes = [], []
    real_ffn, real_route = llama_mod.moe_ffn, moe._route

    def ffn(*args, **kwargs):
        if record_calls:
            calls.append((args, kwargs))
        return real_ffn(*args, **kwargs)

    def route(*args, **kwargs):
        out = real_route(*args, **kwargs)
        routes.append(out[2])
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with ctx(), mock.patch.object(llama_mod, "moe_ffn", ffn), \
            mock.patch.object(moe, "_route", route):
        cache = gen_mod.init_cache(cfg, prompt.shape[0], s,
                                   device=prompt.device)
        start.record()
        logits = gen_mod.forward_with_cache(model, prompt, cache, 0, cfg)[0]
        end.record()
    end.synchronize()
    return logits, routes, calls, start.elapsed_time(end)


def routing_flips(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of tokens whose top-k expert set differs."""
    return (a.sort(dim=-1).values != b.sort(dim=-1).values).any(
        dim=-1).float().mean().item()


def generate_moe_phase(dev, seed: int):
    """19a: ``generate`` at Mixtral-8x7B widths (8 layers, bf16, grouped):
    B 8 x 512-token prompts, 64 new tokens, greedy; the grouped kernels'
    launches exact with their plain versions raising; the prefill's
    expert FFN, kernels against plain, layer by layer on the plain path's
    input (a control must fail); the whole prefill logits, the routing
    flips between the two paths and the tokens they agree on, printed.
    Returns (launches, launches by design)."""
    cfg = mixtral_8x7b(8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev)
    prompt = synthetic_tokens(seed, GEN_BATCH, GEN_MOE_PROMPT,
                              cfg.vocab_size, dev)
    zero_counters()
    with grouped_plain_raise():
        out, rec = timed_generate(model, prompt, cfg,
                                  max_new_tokens=GEN_NEW)
    launches = read_counters()
    by_design = {name: dict(counter(name).launches_by_design)
                 for name in ("gmm", "gmm_swiglu")}
    steps = 1 + (GEN_NEW - 1)
    want = {name: (cfg.n_layers * steps if name in ("gmm", "gmm_swiglu")
                   else 0) for name in launches}
    assert out.shape == (GEN_BATCH, GEN_MOE_PROMPT + GEN_NEW), out.shape
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert launches == want, (launches, want)

    s = rec["cache_len"]
    lk, rk, _, prefill_ms = generate_prefill(model, cfg, prompt, s,
                                             contextlib.nullcontext)
    lp, rp, calls, _ = generate_prefill(model, cfg, prompt, s,
                                        plain_grouped_kernels, True)
    assert torch.isfinite(lk).all() and lk.shape == (
        GEN_BATCH, GEN_MOE_PROMPT, cfg.vocab_size)
    logits_rel = rel_max(lk, lp)
    flips = [routing_flips(a, b) for a, b in zip(rk, rp)]
    del lk, lp, rk, rp
    assert len(calls) == cfg.n_layers, len(calls)
    per_layer = layer_rel_errs(calls, contextlib.nullcontext,
                               plain_grouped_kernels)
    control = layer_rel_errs(calls[:1], expert_rows_zeroed,
                             plain_grouped_kernels)[0]
    del calls
    with plain_grouped_kernels():
        plain_out = gen_mod.generate(model, prompt, cfg,
                                     max_new_tokens=GEN_NEW)
    touched = touched_experts(lambda: gen_mod.forward_with_cache(
        model, out[:, -2:-1], rec["cache"], GEN_MOE_PROMPT + GEN_NEW - 1,
        cfg))
    expert_bytes = 3 * cfg.dim * cfg.intermediate * 2
    dense_bytes = sum(p.numel() * p.element_size()
                      for n, p in model.named_parameters()
                      if n != "embed" and not n.endswith(
                          ("w_gate", "w_up", "w_down")))
    read_bytes = sum(touched) * expert_bytes + dense_bytes
    prof = decode_profile("generate moe decode token", model, cfg,
                          rec["cache"], GEN_MOE_PROMPT)
    print("generate[19a mixtral 8 layers]: " + json.dumps({
        "batch": GEN_BATCH, "prompt": GEN_MOE_PROMPT, "new": GEN_NEW,
        "cache_len": s, "read": "blocked", "launches": launches,
        "launches_by_design": by_design,
        "prefill_ms": prefill_ms,
        "prefill_ms_first_call": rec["prefill_ms"],
        "ms_per_token_p50": rec["ms_per_token_p50"],
        "host_ms_per_token_p50": rec["host_ms_per_token_p50"],
        "peak_gb": rec["peak_gb"], "cache_gb": rec["cache_gb"],
        "touched_experts_per_layer": touched,
        "weights_read_gb_per_step": read_bytes / 1e9,
        "weights_read_floor_ms": read_bytes / PEAK_HBM_BYTES * 1e3,
        "prefill_ffn_rel_per_layer": per_layer, "tol": LAYER_REL_TOL,
        "control_rel": control,
        "prefill_logits_rel_vs_plain": logits_rel,
        "routing_flips_per_layer": flips,
        "tokens_vs_plain": token_agreement(out, plain_out, GEN_MOE_PROMPT),
        "launches_per_decode_token": prof["kernel_launches"],
        "idle_share": prof["idle_share"]}), flush=True)
    assert max(per_layer) <= LAYER_REL_TOL, "a layer's expert FFN disagrees"
    assert control > LAYER_REL_TOL, (
        "the per-layer check passed an FFN output with an expert's rows "
        "zeroed")
    assert flips[0] == 0, "layer 0 routed the same input differently"
    del model, rec, out, plain_out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_design


def teacher_forced_logits(model, cfg, tokens, t_p, quantize, s):
    """The last-position logits at each of the GEN_NEW positions, the
    cache fed ``tokens`` (prompt then the new tokens) rather than its own
    samples: [GEN_NEW, B, vocab]."""
    cache = gen_mod.init_cache(cfg, GEN_BATCH, s, quantize, tokens.device)
    logits, _ = gen_mod.forward_with_cache(model, tokens[:, :t_p], cache, 0,
                                           cfg)
    out = [logits[:, -1]]
    for pos in range(t_p, t_p + GEN_NEW - 1):
        logits, _ = gen_mod.forward_with_cache(
            model, tokens[:, pos:pos + 1], cache, pos, cfg)
        out.append(logits[:, -1])
    return torch.stack(out)


def generate_dense_phase(dev, seed: int):
    """19b: Llama-2-7B at 32 layers, bf16 parameters, B 8 x 2048 + 64,
    greedy, in the four (cache, read) variants; no hand-written kernel
    runs, so every counter stays 0.  Then the int8 cache against the bf16
    one, teacher-forced over the same 64 positions."""
    cfg = llama2_7b_decode(32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev)
    t_p = GEN_DENSE_PROMPT
    prompt = synthetic_tokens(seed, GEN_BATCH, t_p, cfg.vocab_size, dev)
    runs = {}
    for name, (kv_block, quant) in GEN_READS.items():
        zero_counters()
        out, rec = timed_generate(model, prompt, cfg, max_new_tokens=GEN_NEW,
                                  kv_block=kv_block, kv_quant=quant)
        launches = read_counters()
        prof = decode_profile(f"generate 7b decode token {name}", model, cfg,
                              rec["cache"], t_p, kv_block)
        runs[name] = (out, torch.stack(rec["logits"]))
        print(f"generate[19b llama2-7b 32 layers {name}]: " + json.dumps({
            "batch": GEN_BATCH, "prompt": t_p, "new": GEN_NEW,
            "cache_len": rec["cache_len"], "kv_block": kv_block,
            "int8": quant, "prefill_ms": rec["prefill_ms"],
            "ms_per_token_p50": rec["ms_per_token_p50"],
            "host_ms_per_token_p50": rec["host_ms_per_token_p50"],
            "peak_gb": rec["peak_gb"], "cache_gb": rec["cache_gb"],
            "launches": launches,
            "launches_per_decode_token": prof["kernel_launches"],
            "idle_share": prof["idle_share"]}), flush=True)
        assert out.shape == (GEN_BATCH, t_p + GEN_NEW)
        assert torch.isfinite(runs[name][1]).all()
        assert not any(launches.values()), launches
        del rec
        torch.cuda.empty_cache()
    for a, b in (("bf16_blocked", "bf16_dense"),
                 ("int8_blocked", "int8_dense")):
        (ta, la), (tb, lb) = runs[a], runs[b]
        print(f"generate[19b {a} vs {b}]: " + json.dumps({
            "tokens": token_agreement(ta, tb, t_p),
            "max_logit_diff_by_step": (la - lb).abs().amax(
                dim=(1, 2)).tolist()}), flush=True)
    ref_tokens, ref_logits = runs["bf16_blocked"]
    s = -(-(t_p + GEN_NEW) // gen_mod.DECODE_KV_BLOCK) * \
        gen_mod.DECODE_KV_BLOCK
    q_logits = teacher_forced_logits(model, cfg, ref_tokens, t_p, True, s)
    diff = (q_logits - ref_logits).abs()
    agree = (q_logits.argmax(-1) == ref_logits.argmax(-1)).float().mean()
    print("generate[19b int8 vs bf16 cache, teacher-forced]: " + json.dumps({
        "positions": GEN_NEW * GEN_BATCH,
        "max_logit_diff": diff.max().item(),
        "mean_logit_diff": diff.mean().item(),
        "argmax_agreement": agree.item()}), flush=True)
    del runs, q_logits, ref_logits, diff
    torch.cuda.empty_cache()
    long_prefill(model, cfg, seed, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def long_prefill(model, cfg, seed: int, dev) -> dict:
    """One blocked prefill of B 8 x ``GEN_LONG_PROMPT`` on a fresh cache:
    its ms (CUDA events), the peak GB, and the peak over what the model
    and the cache hold beside the f32 scores [B, H, T, span] that one
    unchunked pass of a layer's read would hold; the former must stay
    below the latter (the read takes its query rows in chunks)."""
    t = GEN_LONG_PROMPT
    block = gen_mod.DECODE_KV_BLOCK
    s = -(-(t + GEN_NEW) // block) * block
    prompt = synthetic_tokens(seed + 1, GEN_BATCH, t, cfg.vocab_size, dev)
    cache = gen_mod.init_cache(cfg, GEN_BATCH, s, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits = gen_mod.forward_with_cache(model, prompt, cache, 0, cfg)[0]
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated()
    span = -(-t // block) * block
    one_pass = GEN_BATCH * cfg.n_heads * t * span * 4
    out = {"batch": GEN_BATCH, "prompt": t, "cache_len": s, "read": "blocked",
           "prefill_ms": start.elapsed_time(end), "peak_gb": peak / 1e9,
           "over_model_and_cache_gb": (peak - held) / 1e9,
           "logits_gb": logits.numel() * logits.element_size() / 1e9,
           "one_pass_scores_gb": one_pass / 1e9,
           "chunk_scores_gb": gen_mod.SCORE_CHUNK_BYTES / 1e9}
    print("generate[19b long prefill]: " + json.dumps(out), flush=True)
    assert logits.shape == (GEN_BATCH, t, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert peak - held < one_pass, (
        "the prefill held a layer's whole scores at once")
    del logits, cache
    torch.cuda.empty_cache()
    return out


def generate_mesh_phase(dev, seed: int) -> dict:
    """19c: ``generate(mesh=)`` at Llama-2-7B widths (8 layers, bf16
    parameters) in a one-rank nccl group, 19b's batch and lengths: tokens
    bit-identical to the run with no mesh, host ms per token beside it."""
    from torch.distributed.tensor import DTensor

    from kubeflow_controller_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )

    cfg = llama2_7b_decode(GEN_MESH_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev)
    prompt = synthetic_tokens(seed, GEN_BATCH, GEN_DENSE_PROMPT,
                              cfg.vocab_size, dev)
    zero_counters()
    plain, rec_plain = timed_generate(model, prompt, cfg,
                                      max_new_tokens=GEN_NEW)
    rt = JobRuntime(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0)
    backend = rt.join_group(dev, timeout_s=120)
    try:
        mesh = build_mesh(MeshSpec(fsdp=-1), dev.type)
        llama_mod.shard_llama(model, mesh)
        sharded = all(isinstance(p, DTensor) for p in model.parameters())
        meshed, rec_mesh = timed_generate(model, prompt, cfg,
                                          max_new_tokens=GEN_NEW, mesh=mesh)
    finally:
        rt.shutdown()
    launches = read_counters()
    out = {"backend": backend, "layers": GEN_MESH_LAYERS,
           "params_dtensor": sharded,
           "bit_identical": torch.equal(plain, meshed),
           "tokens": token_agreement(meshed, plain, GEN_DENSE_PROMPT),
           "host_ms_per_token_p50": rec_mesh["host_ms_per_token_p50"],
           "host_ms_per_token_p50_no_mesh":
               rec_plain["host_ms_per_token_p50"],
           "ms_per_token_p50": rec_mesh["ms_per_token_p50"],
           "ms_per_token_p50_no_mesh": rec_plain["ms_per_token_p50"],
           "prefill_ms": rec_mesh["prefill_ms"],
           "prefill_ms_no_mesh": rec_plain["prefill_ms"],
           "peak_gb": rec_mesh["peak_gb"], "launches": launches}
    print("generate[19c one-rank nccl mesh]: " + json.dumps(out), flush=True)
    assert backend == "nccl" and sharded
    assert out["bit_identical"], "the mesh's tokens differ from no mesh's"
    assert not any(launches.values()), launches
    del model, rec_plain, rec_mesh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def generate_phase(dev, seed: int):
    """Phase 19: 19a, 19b, 19c, each with its seconds.  Returns 19a's
    (launches, by design)."""
    t0 = time.perf_counter()
    launches, by_design = generate_moe_phase(dev, seed)
    t1 = time.perf_counter()
    generate_dense_phase(dev, seed)
    t2 = time.perf_counter()
    generate_mesh_phase(dev, seed)
    print("generate: seconds " + json.dumps({
        "19a": t1 - t0, "19b": t2 - t1,
        "19c": time.perf_counter() - t2}), flush=True)
    return launches, by_design


# ---------------------------------------------------------------------------
# Phase 20: pipeline parallelism on one card (virtual stages)
# ---------------------------------------------------------------------------

PP_STEPS = 3
PP_DENSE = {"layers": 8, "stages": 4, "microbatches": 4, "batch": 4,
            "seq_len": 4096}
PP_MOE = {"layers": 2, "stages": 2, "microbatches": 2, "batch": 2,
          "seq_len": 4096}
PP_LOSS_RTOL = 1e-3
PP_GRAD_RTOL = 5e-2
# Launches per layer per real microbatch of a 1F1B step under remat
# "full": the stage forward (one flash_fwd), the stage backward's re-run of
# the stage (one) and, inside its backward, the layer's recompute (one),
# then dq and dkv; the MoE layer's gmm_swiglu and down gmm the same three
# times, then 3 dlhs gmm and 3 tgmm.  What tests/test_torch_pp_train.py
# holds the port to against the pallas_calls of the reference's stage
# forward and ``bwd_one`` jaxprs.  A bubble step launches nothing.
PP_LAUNCHES_PER_LAYER = {"flash_fwd": 3, "flash_dq": 1, "flash_dkv": 1}
PP_MOE_LAUNCHES_PER_LAYER = {"gmm_swiglu": 3, "gmm": 6, "tgmm": 3,
                             **PP_LAUNCHES_PER_LAYER}


def pp_sp_launches_per_layer(kind: str, sp_index: int) -> dict:
    """``PP_LAUNCHES_PER_LAYER`` for the rank at ``sp_index`` of a stage's
    sp group: the causal ring runs the flash kernels on each K/V block at
    or below its own, ``sp_index + 1`` of them, wherever one device runs
    them once; Ulysses runs them once, on the whole T of a head shard."""
    n = sp_index + 1 if kind == "ring" else 1
    return {k: v * n for k, v in PP_LAUNCHES_PER_LAYER.items()}


@contextmanager
def all_plain_raise():
    """Every kernel's plain version raises while this is open."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the pp path")
    with contextlib.ExitStack() as stack:
        for mod, name in ((gm, "gmm_plain"), (gm, "gmm_swiglu_plain"),
                          (gm, "tgmm_plain"), (at, "flash_fwd_plain"),
                          (at, "flash_dq_plain"), (at, "flash_dkv_plain")):
            stack.enter_context(mock.patch.object(mod, name, refuse))
        yield


def pp_want(cfg: LlamaConfig, per_layer: dict, microbatches: int,
            steps: int = 1) -> dict:
    return {name: n * cfg.n_layers * microbatches * steps
            for name, n in per_layer.items()}


def pp_check(label: str, cfg: LlamaConfig, dev, seed: int, run: dict,
             per_layer: dict) -> dict:
    """One 1F1B step (``llama_loss_and_grads_pp`` over ``run``'s virtual
    stages and microbatches) against ``llama_loss`` + backward on the same
    init and batch: the loss within ``PP_LOSS_RTOL`` relative, every
    gradient within ``PP_GRAD_RTOL`` relative norm, and the launches of the
    pp step (counters zeroed just before, read just after) as predicted."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev, requires_grad=True)
    tokens = synthetic_tokens(seed, run["batch"], run["seq_len"],
                              cfg.vocab_size, dev)
    with all_plain_raise():
        loss = llama_loss(model, tokens, cfg)
        loss.backward()
        ref_loss = loss.item()
        ref = {}
        for n, p in model.named_parameters():
            ref[n], p.grad = p.grad, None
        del loss
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        pp_loss, grads = llama_mod.llama_loss_and_grads_pp(
            model, tokens, cfg, n_microbatches=run["microbatches"],
            n_stages=run["stages"])
        pp_loss = pp_loss.item()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counters()
    rel = {n: ((grads[n].float() - ref[n].float()).norm()
               / ref[n].float().norm().clamp_min(1e-30)).item() for n in ref}
    worst = max(rel, key=rel.get)
    want = {k: v for k, v in pp_want(cfg, per_layer,
                                     run["microbatches"]).items()}
    got = {k: launches[k] for k in want}
    rec = {"layers": cfg.n_layers, **run, "loss_pp": pp_loss,
           "loss_ref": ref_loss,
           "loss_rel_err": abs(pp_loss - ref_loss) / abs(ref_loss),
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "first_step_wall_ms": wall_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": got, "want": want,
           "tol": {"loss": PP_LOSS_RTOL, "grad": PP_GRAD_RTOL}}
    print(f"{label} 1F1B vs llama_loss: " + json.dumps(rec), flush=True)
    assert abs(pp_loss - ref_loss) <= PP_LOSS_RTOL * abs(ref_loss), label
    assert rel[worst] <= PP_GRAD_RTOL, f"{label}: gradient {worst}"
    assert got == want, (label, got, want)
    del model, ref, grads
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def pp_train(label: str, cfg: LlamaConfig, dev, seed: int, run: dict,
             per_layer: dict) -> dict:
    """``PP_STEPS`` steps of ``llama_pretrain.train(pp=, microbatches=)``
    on virtual stages, the launch counters zeroed just before and read just
    after: each as predicted.  Every loss finite; ms p50, peak GB."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with all_plain_raise():
        res = llama_pretrain.train(
            cfg, steps=PP_STEPS, batch_size=run["batch"],
            seq_len=run["seq_len"], lr=3e-4, device=dev, seed=seed,
            pp=run["stages"], microbatches=run["microbatches"])
    launches = read_counters()
    want = pp_want(cfg, per_layer, run["microbatches"], PP_STEPS)
    got = {k: launches[k] for k in want}
    p50 = statistics.median(res.step_s)
    S, M = run["stages"], run["microbatches"]
    rec = {"layers": cfg.n_layers, **run, "steps": PP_STEPS,
           "losses": res.losses, "step_ms": [x * 1e3 for x in res.step_s],
           "step_ms_p50": p50 * 1e3,
           "tokens_per_s_p50": run["batch"] * run["seq_len"] / p50,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bubble_share": (2 * S - 2) / (M + 2 * S - 2),
           "launches": got, "want": want}
    print(f"{label} train: " + json.dumps(rec), flush=True)
    assert got == want, (label, got, want)
    assert all(np.isfinite(x) for x in res.losses), res.losses
    assert rec["peak_mem_gb"] < 80, rec["peak_mem_gb"]
    # One more step of the same loop, profiled (beside phase 8's).
    rec["profile"] = profile_calls(f"{label} step",
                                   lambda: res.step(PP_STEPS + 1), 1)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def pp_phase(dev, seed: int, dense_step: dict) -> dict:
    """Phase 20 (see the docstring): 20a dense, 20b MoE.  Returns the
    launches of each timed run, by path."""
    t0 = time.perf_counter()
    dense = llama2_7b(n_layers=PP_DENSE["layers"])
    pp_check("pp 20a dense", dense, dev, seed, PP_DENSE,
             PP_LAUNCHES_PER_LAYER)
    a = pp_train("pp 20a dense", dense, dev, seed, PP_DENSE,
                 PP_LAUNCHES_PER_LAYER)
    print("pp 20a against the non-pp step (phase 8): " + json.dumps({
        "pp_ms_p50": a["step_ms_p50"], "pp_peak_gb": a["peak_mem_gb"],
        "non_pp_ms_p50": dense_step["step_ms_p50"],
        "non_pp_peak_gb": dense_step["peak_mem_gb"]}), flush=True)
    t1 = time.perf_counter()
    moe_cfg = mixtral_8x7b_train(PP_MOE["layers"])
    pp_check("pp 20b moe", moe_cfg, dev, seed, {**PP_MOE, "microbatches": 1},
             PP_MOE_LAUNCHES_PER_LAYER)
    b = pp_train("pp 20b moe", moe_cfg, dev, seed, PP_MOE,
                 PP_MOE_LAUNCHES_PER_LAYER)
    print("pp: seconds " + json.dumps({"20a": t1 - t0,
                                       "20b": time.perf_counter() - t1}),
          flush=True)
    return {"pp_dense": a["launches"], "pp_moe": b["launches"]}


# ---------------------------------------------------------------------------
# Phase 21: the graft-entry hooks and the workload traces
# ---------------------------------------------------------------------------

TRACED_WORKLOADS = (
    ("llama_pretrain", ["--preset", "tiny", "--steps", "2"]),
    ("mnist_dist", ["--steps", "20", "--step-loop"]),
    ("mnist_local", ["--steps", "20"]),
)
# The spans the traced workloads dump, each this often (one process, so
# no runtime/* span).
TRACED_SPANS = {"workload/compile": 1, "workload/first_step": 3,
                "workload/fit": 2, "workload/host_setup": 1,
                "workload/init": 1, "workload/rendezvous": 1,
                "workload/stage": 1, "workload/train": 1}
SERVE_TRACE_LAYERS = 2


def entry_hook_phase() -> dict:
    """21a: the flagship forward of ``graft_entry.entry()`` on the card."""
    fn, args = graft_entry.entry()
    with torch.no_grad():
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
    rec = {"shape": list(out.shape), "dtype": str(out.dtype),
           "device": str(out.device),
           "ms": (time.perf_counter() - t0) * 1e3}
    print("entry: graft_entry.entry() forward " + json.dumps(rec),
          flush=True)
    assert tuple(out.shape) == (2, 64, 512) and out.dtype == torch.float32
    assert out.device.type == "cuda" and torch.isfinite(out).all()
    return rec


def dumped_events(trace_dir: str) -> list:
    """Every span the processes dumped into ``trace_dir``, once each: a
    process dumps at the end of its ``main`` and again at exit, and the
    controller's merge keeps one event a span id."""
    events = {}
    for name in sorted(os.listdir(trace_dir)):
        if name.startswith("trace-") and name.endswith(".json"):
            with open(os.path.join(trace_dir, name)) as fh:
                for e in json.load(fh)["traceEvents"]:
                    events.setdefault(e["args"]["span_id"], e)
    return list(events.values())


def traced_workloads_phase(seed: int) -> dict:
    """21b: the workloads as the node agent starts them, under one job's
    trace context; their dumps must form one tree under it."""
    ctx = trace.TraceContext.for_job(f"chip-smoke-{seed}")
    SMOKE_DIR.mkdir(exist_ok=True)
    trace_dir = tempfile.mkdtemp(dir=SMOKE_DIR)
    drop = tempfile.mkdtemp(dir=SMOKE_DIR)
    t0 = time.perf_counter()
    procs = {}
    try:
        # The three pods at once, as a node runs them.
        for i, (name, argv) in enumerate(TRACED_WORKLOADS):
            env = dict(os.environ, KCTPU_TRACE_CONTEXT=ctx.encode(),
                       KCTPU_TRACE_DIR=trace_dir, KCTPU_PROGRESS_DIR=drop,
                       KCTPU_POD_NAMESPACE="default",
                       KCTPU_POD_NAME=f"chip-smoke-trace-{i}")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m",
                 f"kubeflow_controller_tpu_torch.workloads.{name}", *argv],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (name, err[-3000:])
            assert "Final loss" in out, (name, out[-2000:])
        wall_s = time.perf_counter() - t0
        events = dumped_events(trace_dir)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(trace_dir, ignore_errors=True)
        shutil.rmtree(drop, ignore_errors=True)
    ids = {e["args"]["span_id"] for e in events}
    for e in events:
        args = e["args"]
        assert args["trace_id"] == ctx.trace_id, e
        assert args["parent_id"] in ids | {ctx.span_id}, e
    names = {n: sum(e["name"] == n for e in events)
             for n in sorted({e["name"] for e in events})}
    (compiled,) = [e["args"] for e in events
                   if e["name"] == "workload/compile"]
    rec = {"spans": names, "compile": compiled,
           "processes": len({e["pid"] for e in events}),
           "wall_s": wall_s}
    print("traces: " + json.dumps(rec), flush=True)
    assert compiled["source"] == "cache-hit", compiled
    assert names == TRACED_SPANS, (names, TRACED_SPANS)
    assert rec["processes"] == len(TRACED_WORKLOADS), rec
    return rec


def traced_serve_phase(dev, seed: int) -> dict:
    """21c: phase 5's requests through an engine built under a trace
    context; returns the launch counts."""
    cfg = mixtral_8x7b(SERVE_TRACE_LAYERS)
    backend = LlamaBackend(cfg, seed=seed, device=dev)
    ctx = trace.TraceContext.for_job(f"chip-smoke-serve-{seed}")
    reqs = serve_requests(cfg, seed)
    zero_counters()
    with trace.context(ctx):
        engine = ServeEngine(backend, SERVE_CONFIG)
    engine.start()
    assert engine.wait_ready(900), "engine never became ready"
    for r in reqs:
        assert engine.submit(r), r.id
    for r in reqs:
        assert r.done.wait(900), f"{r.id} never finished"
    engine.drain()
    assert engine._drained.wait(60)
    engine.stop()
    launches = read_counters()
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    spans = [s for s in trace.TRACER.spans() if s.trace_id == ctx.trace_id]
    chains = {}
    for sp in spans:
        if sp.name == "serve/request":
            assert sp.parent_id == ctx.span_id, sp
            kids = sorted((k for k in spans if k.parent_id == sp.span_id),
                          key=lambda k: k.ts)
            assert [k.name for k in kids] == [
                "serve/queue_wait", "serve/prefill", "serve/decode"], kids
            for k in kids:
                assert sp.ts - 1e-6 <= k.ts <= k.ts + k.dur <= (
                    sp.ts + sp.dur + 1e-3), (sp, k)
            chains[sp.args["request"]] = {
                "ms": sp.dur * 1e3, **{k.name.split("/")[1] + "_ms":
                                       k.dur * 1e3 for k in kids}}
    print("traces: serve/request chains " + json.dumps(chains), flush=True)
    assert sorted(chains) == sorted(r.id for r in reqs), sorted(chains)
    assert len(spans) == 4 * len(reqs), len(spans)
    assert launches["gmm"] > 0 and launches["gmm_swiglu"] > 0, launches
    return launches


# ---------------------------------------------------------------------------
# Phase 22: pipeline parallelism under sequence parallelism, rank by rank
# ---------------------------------------------------------------------------

PP_SP = {"layers": 4, "pp": 2, "sp": 2, "microbatches": 2, "batch": 2,
         "seq_len": 8192}
# Rank processes on the card at a time (a rank peaks at 13.4 GB on an
# H100, beside what this process still holds).
PP_SP_AT_ONCE = 2


def pp_sp_rank(rank: int, dev, seed: int) -> list:
    """Run in a child process (``--pp-sp-rank``): this process as ``rank``
    of a (pp 2, sp 2) mesh under torch's fake process group (collectives
    and point-to-point ops do nothing, a received buffer holding whatever
    it held; DTensor's sharding propagation runs in full), one step of
    ``llama_pretrain.train`` with ring, then with Ulysses attention, every
    plain version patched to raise and the flash fallback warning an
    error, the launch counters zeroed just before and read just after
    each.  The values are not checked: the hand-offs and the ring's blocks
    are never received (the 4-card run of ``tools/mesh_cards.py --pp
    --sp`` holds them).  One process group a process: torch keeps a
    destroyed group's sub-meshes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=PP_SP["pp"] * PP_SP["sp"])
    recs = []
    try:
        mesh = build_mesh(MeshSpec(pp=PP_SP["pp"], fsdp=1, sp=PP_SP["sp"]),
                          dev.type)
        for kind in ("ring", "ulysses"):
            cfg = replace(llama2_7b(PP_SP["layers"]), attention="flash",
                          sp_attention=kind)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            with all_plain_raise(), warnings.catch_warnings():
                warnings.filterwarnings("error", message="attention='flash'")
                res = llama_pretrain.train(
                    cfg, steps=1, batch_size=PP_SP["batch"],
                    seq_len=PP_SP["seq_len"], device=dev, seed=seed,
                    mesh=mesh, microbatches=PP_SP["microbatches"])
            recs.append({"kind": kind, "rank": rank,
                         "sp_index": mesh.get_local_rank("sp"),
                         "launches": {k: v for k, v in
                                      read_counters().items()
                                      if k in FLASH_KERNELS},
                         "step_ms": res.step_s[0] * 1e3,
                         "peak_mem_gb":
                             torch.cuda.max_memory_allocated() / 1e9})
            del res
    finally:
        dist.destroy_process_group()
    return recs


def pp_sp_children(seed: int) -> list:
    """:func:`pp_sp_rank` for every rank, each in a child process of this
    script, ``PP_SP_AT_ONCE`` at a time; every child is waited for (killed
    at its time limit)."""
    SMOKE_DIR.mkdir(exist_ok=True)
    ranks = list(range(PP_SP["pp"] * PP_SP["sp"]))
    recs = []
    for lo in range(0, len(ranks), PP_SP_AT_ONCE):
        outs = {r: SMOKE_DIR / f"pp-sp-{os.getpid()}-{r}.json"
                for r in ranks[lo:lo + PP_SP_AT_ONCE]}
        procs = {r: subprocess.Popen([sys.executable, __file__, "--seed",
                                      str(seed), "--pp-sp-rank", str(r),
                                      str(out)])
                 for r, out in outs.items()}
        try:
            for r, p in procs.items():
                assert p.wait(timeout=600) == 0, f"pp_sp rank {r} exited " \
                    f"{p.returncode}"
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, out in outs.items():
            recs += json.loads(out.read_text())
            out.unlink()
    return recs


def pp_sp_phase(seed: int) -> dict:
    """Phase 22 (see the docstring): every rank of the (pp 2, sp 2) mesh,
    ring and Ulysses, each rank's flash launches held to
    ``pp_sp_launches_per_layer`` of its sp index times its stage's layers
    and the microbatches.  Returns each pass's launches over its four
    ranks, by path."""
    t0 = time.perf_counter()
    recs = pp_sp_children(seed)
    layers = PP_SP["layers"] // PP_SP["pp"]
    paths = {}
    for kind in ("ring", "ulysses"):
        mine = [r for r in recs if r["kind"] == kind]
        for r in mine:
            r["want"] = {k: v * layers * PP_SP["microbatches"] for k, v in
                         pp_sp_launches_per_layer(kind,
                                                  r["sp_index"]).items()}
        print(f"pp_sp 22 {kind}: " + json.dumps({**PP_SP, "ranks": mine}),
              flush=True)
        for r in mine:
            assert r["launches"] == r["want"], (kind, r)
        assert len(mine) == PP_SP["pp"] * PP_SP["sp"], mine
        paths[f"pp_sp_{kind}"] = {k: sum(r["launches"][k] for r in mine)
                                  for k in FLASH_KERNELS}
    print(f"pp_sp: seconds {time.perf_counter() - t0:.3f}", flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 23: the pod path on one card
# ---------------------------------------------------------------------------

POD = {"layers": 2, "batch": 1, "seq_len": 4096, "steps": 3}
POD_ARGV = ["--preset", "llama2-7b", "--n-layers", str(POD["layers"]),
            "--batch-size", str(POD["batch"]), "--seq-len",
            str(POD["seq_len"]), "--steps", str(POD["steps"])]
POD_MODULE = "kubeflow_controller_tpu_torch.workloads.llama_pretrain"
COORDINATOR_PORT = 8476         # TPUSpec's default coordinatorPort


def pod_env(job: str, index: int, pods: int, accel: str, port: int,
            mesh=None) -> dict:
    """The env the controller gives pod ``index`` of a TPU-typed job of
    ``pods`` one-host slices of ``accel`` (``_wire_tpu_pod`` in the JAX
    package's ``planner/materialize.py``), with the node agent's loopback
    coordinator at ``port`` and ``mesh`` as ``$KCTPU_MESH``.  The pod's
    cards are not here: the inventory sets them on the pod
    (:func:`gang_pods`, :func:`admit`, :func:`container_env`)."""
    host = f"host-{index}.{job}--tpu"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KCTPU_", "JAX_", "TPU_", "MEGASCALE_"))
           and k != topology.ENV_VISIBLE_DEVICES}
    env.update({
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(pods), "JAX_PROCESS_ID": str(index),
        "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": host,
        "TPU_ACCELERATOR_TYPE": accel,
        "MEGASCALE_NUM_SLICES": str(pods), "MEGASCALE_SLICE_ID": str(index),
        "MEGASCALE_COORDINATOR_ADDRESS": f"{host}:{COORDINATOR_PORT}",
        "KCTPU_GANG_GENERATION": "0", "KCTPU_GANG_NAME": f"{job}-",
        "PYTHONPATH": str(Path(__file__).resolve().parent)})
    if mesh:
        env["KCTPU_MESH"] = json.dumps(mesh, sort_keys=True)
    return env


class StandInContainer:
    """A pod's container as the inventory reads and stamps it: its env
    (``set_env``, the reference's upsert) and its chip request."""

    def __init__(self, chips: int):
        self.env = []
        chips_req = {gpu_inventory.RESOURCE_TPU: str(chips)}
        self.resources = SimpleNamespace(requests=dict(chips_req),
                                         limits=dict(chips_req))

    def set_env(self, name: str, value: str) -> None:
        for e in self.env:
            if e.name == name:
                e.value = value
                return
        self.env.append(SimpleNamespace(name=name, value=value))


def gang_pods(job: str, pods: int, accel: str) -> list:
    """Stand-ins for the pods of a TPU-typed job of ``pods`` one-host
    slices of ``accel``, with the annotations ``_wire_tpu_pod`` gives
    them (gang name ``<job>-``, as ``pod_env``'s ``$KCTPU_GANG_NAME``)."""
    out = []
    for i in range(pods):
        out.append(SimpleNamespace(
            metadata=SimpleNamespace(
                name=f"{job}-tpu-{i}", namespace="default", annotations={
                    gpu_inventory.ANNOTATION_GANG_NAME: f"{job}-",
                    gpu_inventory.ANNOTATION_GANG_SIZE: str(pods),
                    gpu_inventory.ANNOTATION_ACCELERATOR: accel,
                    gpu_inventory.ANNOTATION_NUM_SLICES: str(pods),
                    gpu_inventory.ANNOTATION_SLICE_INDEX: str(i)}),
            spec=SimpleNamespace(containers=[StandInContainer(
                gpu_inventory.slice_cards(accel))])))
    return out


def admit(inventory, pods: list) -> bool:
    """Offer each pod of a gang, as the node agent's gate does, and once
    more after the last member completed the gang: True iff every member
    is admitted."""
    return (all([inventory.offer(p) for p in pods])
            or all(inventory.offer(p) for p in pods))


def container_env(pod) -> dict:
    return {e.name: e.value for e in pod.spec.containers[0].env}


def host_record(host) -> dict:
    """The discovered host as one JSON object, with the card line."""
    return {"name": host.name, "card": card_line(), "family": host.family,
            "cards": [{"index": c.index, "uuid": c.uuid, "pci": c.pci_bus_id}
                      for c in host.cards],
            "nvlink_domains": [list(d) for d in host.nvlink_domains]}


def reports(text: str) -> list:
    """The ``Report: {...}`` lines of a pod's or a rank's output (a pod's
    other ranks' lines carry a ``[rank g]`` prefix), by global rank."""
    recs = [json.loads(line.split("Report: ", 1)[1])
            for line in text.splitlines() if "Report: {" in line]
    return sorted(recs, key=lambda r: r["rank"])


def pod_phase_child() -> dict:
    """Run in the child (``--pod-phase``): bind the one pod of a one-host
    ``h100-1`` TPU job to a card of this host's inventory, run
    ``llama_pretrain.main`` at ``POD``'s size in a one-rank nccl group on
    that card in this process, then the same flags as the pod: a child
    ``python -m ...llama_pretrain --device cuda --report`` with the pod's
    env and the cards the inventory set on it.  Then release, bind again,
    and fail the slice.  Returns the record."""
    host = topology.discover_host(socket.gethostname())
    print("pod: host " + json.dumps(host_record(host)), flush=True)
    accel = f"{host.family}-1"
    inventory = gpu_inventory.GPUInventory(gpu_inventory.carve(host, 1))
    free = inventory.free_slice_count(accel)
    [pod] = gang_pods("smoke-pod", 1, accel)
    assert admit(inventory, [pod]), "no free card for the pod"
    gang = pod.metadata.annotations[gpu_inventory.ANNOTATION_GANG_NAME]
    [bound] = inventory.cards_of(gang, 0)
    dev = torch.device("cuda", [c.uuid for c in host.cards].index(bound))
    counters = {name: (counter(name), "launches") for name in FLASH_KERNELS}
    rc, res, out, launches, peak_gb, world, backend = main_in_one_rank_group(
        dev, POD_ARGV, counters)
    in_process = {"rc": rc, "backend": backend, "world": world,
                  "losses": res.losses, "launches": launches,
                  "step_ms": [x * 1e3 for x in res.step_s],
                  "peak_mem_gb": peak_gb}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    uuid = llama_pretrain.card_id(dev)
    env = {**pod_env("smoke-pod", 0, 1, accel, free_port()),
           **container_env(pod)}
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", POD_MODULE, *POD_ARGV, "--device", "cuda",
         "--report"], env=env, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    for line in run.stdout.splitlines():
        print(f"pod: {line}", flush=True)
    assert run.returncode == 0, (run.returncode, run.stderr[-3000:])
    [rep] = reports(run.stdout)
    slice_name = inventory.gang_slice(gang)
    inventory.release_gang(gang)
    freed = inventory.free_slice_count(accel)
    [again] = gang_pods("smoke-pod", 1, accel)
    rebound = admit(inventory, [again])
    failed = inventory.fail_slice(inventory.gang_slice(gang))
    return {"in_process": in_process, "pod": rep, "pod_stdout":
            run.stdout, "card": uuid, "pod_wall_s": wall,
            "pod_first_step_s": rep["first_step_unix"] - t0,
            "inventory": {
                "host": host.name, "slices": len(inventory.slices),
                "free_before": free, "bound_card": bound,
                "visible_devices": env[topology.ENV_VISIBLE_DEVICES],
                "slice": slice_name, "free_after_release": freed,
                "rebound": rebound,
                "rebound_cards": container_env(again)[
                    topology.ENV_VISIBLE_DEVICES],
                "failed": failed, "free_after_fail": (
                    inventory.free_slice_count(accel))}}


def pod_phase(seed: int) -> dict:
    """Phase 23 (see the docstring), in a child process of this script
    with cuBLAS's deterministic workspace on both sides.  Returns the
    pod's flash launches, its path's counts."""
    out = SMOKE_DIR / f"pod-{os.getpid()}.json"
    SMOKE_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, __file__, "--seed", str(seed),
                          "--pod-phase", str(out)], env=env, timeout=900)
    assert res.returncode == 0, f"pod child exited {res.returncode}"
    rec = json.loads(out.read_text())
    out.unlink()
    one, rep, inv = rec["in_process"], rec["pod"], rec["inventory"]
    want = {"flash_fwd": 2 * POD["layers"] * POD["steps"],
            "flash_dq": POD["layers"] * POD["steps"],
            "flash_dkv": POD["layers"] * POD["steps"]}
    got = {k: rep["launches"][k] for k in FLASH_KERNELS}
    summary = {
        **POD, "pod": {k: rep[k] for k in (
            "rank", "world", "process", "processes", "local_rank",
            "local_devices", "launched", "device", "card", "backend",
            "losses", "step_ms", "peak_mem_gb")},
        "pod_launches": rep["launches"], "want": want,
        "in_process": one, "card": rec["card"],
        "losses_bit_identical": rep["losses"] == one["losses"],
        "pod_wall_s": rec["pod_wall_s"],
        "pod_first_step_s": rec["pod_first_step_s"], "inventory": inv}
    print("pod: " + json.dumps(summary), flush=True)
    assert inv["visible_devices"] == inv["bound_card"], inv
    assert rec["card"].split()[0].lower() == inv["bound_card"].lower(), \
        (rec["card"], inv)
    assert inv["free_after_release"] == inv["free_before"], inv
    assert inv["rebound"] and inv["rebound_cards"] == inv["bound_card"], inv
    assert inv["failed"] == ["default/smoke-pod-tpu-0"], inv
    assert inv["free_after_fail"] == inv["free_before"] - 1, inv
    assert one["rc"] == 0 and one["backend"] == "nccl" and one["world"] == 1
    assert one["launches"] == want, (one["launches"], want)
    assert rep["launched"] and rep["backend"] == "nccl", rep
    assert (rep["world"], rep["local_devices"], rep["rank"]) == (1, 1, 0), rep
    assert rep["device"] == "cuda:0" and rep["card"] == rec["card"], rep
    assert rep["launches"] == {**{k: 0 for k in rep["launches"]}, **want}, \
        (rep["launches"], want)
    assert summary["losses_bit_identical"], (rep["losses"], one["losses"])
    assert ("Mesh: {'pp': 1, 'dp': 1, 'fsdp': 1, 'ep': 1, 'sp': 1, 'tp': 1} "
            "over 1 devices, process 0/1") in rec["pod_stdout"]
    assert f"Rank 0/1: local 0/1 on cuda:0 ({rec['card']}), nccl" in \
        rec["pod_stdout"]
    return got


# ---------------------------------------------------------------------------
# Phase 24: the one-program fits
# ---------------------------------------------------------------------------

# The fits that run as one CUDA graph on the card, each at its entry
# point's defaults, with its steps and whether its optimizer is Adam(W).
ONE_PROGRAM_FITS = (
    ("mnist_dist", lambda: mnist_dist.run_worker(mnist_dist.parse_args([])),
     200, True),
    ("mnist_local", lambda: mnist_local.train(), 200, True),
    ("flax_mnist", lambda: flax_mnist.run(flax_mnist.parse_args([])), 50,
     True),
    ("cifar_allreduce resnet18",
     lambda: cifar_allreduce.run(cifar_allreduce.parse_args([])), 20, False),
)
# The runtime calls that launch one kernel.
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")


@contextmanager
def watched_programs(eager: bool = False):
    """Every ``trainer.OneProgram`` made inside, listed, with the seconds
    of its ``compile`` and ``run``; a profiler (CPU and CUDA activity) is
    on from the end of the capture to the end of the run, so its events
    are the fit's window.  ``eager`` runs each fit's body eagerly on the
    card instead (the step loop a fit was before it was one graph)."""
    from kubeflow_controller_tpu_torch.workloads import trainer

    made = []
    real_init = trainer.OneProgram.__init__
    real_compile = trainer.OneProgram.compile
    real_run = trainer.OneProgram.run

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.times, self.prof = {}, None
        made.append(self)

    def compile_(self):
        t0 = time.perf_counter()
        out = real_compile(self)
        self.times["compile_s"] = time.perf_counter() - t0
        if not eager:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        return out

    def run(self):
        t0 = time.perf_counter()
        try:
            return real_run(self)
        finally:
            self.times["run_s"] = time.perf_counter() - t0
            if self.prof is not None:
                self.prof.__exit__(None, None, None)

    patches = [mock.patch.object(trainer.OneProgram, "__init__", init),
               mock.patch.object(trainer.OneProgram, "compile", compile_),
               mock.patch.object(trainer.OneProgram, "run", run)]
    if eager:
        patches.append(mock.patch.object(trainer.OneProgram, "on_card",
                                         property(lambda self: False)))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield made


def window_calls(prof) -> dict:
    """Graph launches, kernel launches and the device's kernel time in a
    profiled window."""
    events = prof.events()
    device_us = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"graph_launches": sum(e.name == "cudaGraphLaunch"
                                  for e in events),
            "kernel_launches": sum(e.name in KERNEL_LAUNCH_CALLS
                                   for e in events),
            "device_kernels": sum(e.device_type
                                  == torch.autograd.DeviceType.CUDA
                                  for e in events),
            "device_ms": device_us / 1e3}


def fit_losses(res) -> torch.Tensor:
    return res.losses.detach().cpu()


def nccl_scan_check(dev, steps: int = 50) -> dict:
    """``mnist_dist``'s scan fit with no group, then in a one-rank nccl
    group (``JobRuntime.join_group``): the captured ``all_reduce`` (one of
    n_params + 1 floats a step, one of 2 for the eval) gives per-step
    losses and parameters bit-identical to the run with no group."""
    import torch.distributed as dist

    argv = ["--steps", str(steps)]
    assert not dist.is_initialized()
    plain = mnist_dist.run_worker(mnist_dist.parse_args(argv))
    rt = JobRuntime(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0)
    backend = rt.join_group(dev, timeout_s=120)
    captured, outside = [], []
    real = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        (captured if torch.cuda.is_current_stream_capturing()
         else outside).append(tensor.numel())
        return real(tensor, *args, **kwargs)

    try:
        with mock.patch.object(dist, "all_reduce", counted):
            grouped = mnist_dist.run_worker(mnist_dist.parse_args(argv))
        torch.cuda.synchronize()
    finally:
        rt.shutdown()
    n_params = sum(p.numel() for p in grouped.model.parameters())
    same_losses = torch.equal(fit_losses(plain), fit_losses(grouped))
    same_params = all(torch.equal(a, b) for a, b in zip(
        plain.model.parameters(), grouped.model.parameters()))
    rec = {"backend": backend, "steps": steps,
           "captured_collectives": len(captured),
           "sizes_ok": captured == [n_params + 1] * steps + [2],
           "warmup_collectives": outside,
           "losses_bit_identical": same_losses,
           "params_bit_identical": same_params,
           "accuracy": [plain.accuracy, grouped.accuracy]}
    print("one-program nccl: " + json.dumps(rec), flush=True)
    assert backend == "nccl" and rec["sizes_ok"], (backend, captured[:3])
    assert same_losses and same_params
    assert grouped.accuracy == plain.accuracy
    assert not dist.is_initialized()
    return rec


def generator_ms(dev, n: int, reps: int = 5) -> dict:
    """The threefry draw of ``n`` synthetic MNIST examples on the card:
    as the fit runs it, one CUDA graph replayed (``graph_ms``), and
    eagerly, each operation launched from the host (``eager_ms``); the
    median of ``reps`` each (CUDA events)."""
    from kubeflow_controller_tpu_torch.workloads import data

    means = torch.from_numpy(np.array(data.mnist_teacher_means())).to(dev)
    data.synthetic_mnist_traced(1, n, means, dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        data.synthetic_mnist_traced(1, n, means, dev)
    out = {}
    for mode, run in (("graph_ms", graph.replay), ("eager_ms", lambda:
                      data.synthetic_mnist_traced(1, n, means, dev))):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[mode] = statistics.median(times)
    del graph
    return out


def one_program_phase(dev) -> dict:
    """The one-program fits (phase 24 in the docstring).  Returns the
    launch counters across them (all 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {name: getattr(at, name) for name in FLASH_KERNELS}
    counters.update({name: getattr(gm, name) for name in GROUPED_KERNELS})
    for c in counters.values():
        c.launches = 0
    recs = {}
    for name, fit, steps, adam in ONE_PROGRAM_FITS:
        gc.collect()
        torch.cuda.empty_cache()
        with watched_programs() as made:
            res = fit()
        (prog,) = made
        calls = window_calls(prog.prof)
        losses = fit_losses(res)
        with watched_programs(eager=True) as eager:
            eager_res = fit()
        (eager_prog,) = eager
        eager_losses = fit_losses(eager_res)
        rec = {"steps": steps, **calls,
               "capture_s": prog.times["compile_s"],
               "replay_ms": prog.times["run_s"] * 1e3,
               "us_per_step": prog.times["run_s"] * 1e6 / steps,
               "eager_us_per_step": eager_prog.times["run_s"] * 1e6 / steps,
               "eager_vs_graph_max_abs": float(
                   (losses - eager_losses).abs().max()),
               "eager_vs_graph_first3_max_abs": float(
                   (losses[:3] - eager_losses[:3]).abs().max()),
               "final_loss": float(losses[-1])}
        if adam:
            counts = {float(s["step"]) for s in
                      prog.optimizer.inner.state.values()}
            rec["adam_steps"] = sorted(counts)
        print(f"one-program {name}: " + json.dumps(rec), flush=True)
        assert calls["graph_launches"] == 1, (name, calls)
        assert calls["kernel_launches"] == 0, (name, calls)
        assert losses.shape == (steps,) and torch.isfinite(losses).all()
        if adam:
            assert rec["adam_steps"] == [float(steps)], rec["adam_steps"]
        recs[name] = rec
        del res, eager_res, made, eager, prog, eager_prog
    gen = {"train": generator_ms(dev, 81 * 100),
           "eval": generator_ms(dev, 2048)}
    gen["graph_share_of_replay"] = (
        (gen["train"]["graph_ms"] + gen["eval"]["graph_ms"])
        / recs["mnist_dist"]["replay_ms"])
    print("one-program generator: " + json.dumps(gen), flush=True)
    recs["generator"] = gen
    recs["nccl"] = nccl_scan_check(dev)
    launches = {name: c.launches for name, c in counters.items()}
    assert not any(launches.values()), launches
    return launches



def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernels_line(results, flash, paths, serve_designs, generate_designs):
    """One entry per kernel; ``launches`` is the MoE train run's (the
    path that launches all six) and the grouped kernels' top-level times
    are at its layout; ``launches_by_path`` gives each path's own run
    (``mesh_moe``: the mesh MoE step; ``ring_n4``, ``ring_n2``,
    ``ulysses_n4``: the sequence-parallel paths of phase 18; ``generate``:
    phase 19a's ``generate`` call; ``pp_sp_ring``, ``pp_sp_ulysses``:
    phase 22's four ranks summed; ``pod``: phase 23's pod),
    ``skip_launches_by_path`` the
    launches of ``gmm`` and ``tgmm`` that carried ``valid_tiles``, and
    ``serve_launches_by_design`` and ``generate_launches_by_design`` the
    serve run's and the generate call's ``gmm`` and ``gmm_swiglu``
    launches by design."""
    replaces = {
        "gmm": (f"{REF_FILE}:132 (_gmm_single_k_kernel, decode); "
                f"{REF_FILE}:78 (_gmm_kernel, prefill); "
                f"{REF_FILE}:138 (_gmm_single_k_skip_kernel)"),
        "gmm_swiglu": f"{REF_FILE}:227 (_gmm2_kernel)",
        "tgmm": TGMM_SOURCE_LINES,
        "flash_fwd": f"{FLASH_REF}:62 (_fwd_kernel)",
        "flash_dq": f"{FLASH_REF}:174 (_dq_kernel)",
        "flash_dkv": f"{FLASH_REF}:208 (_dkv_kernel)",
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    main_path = paths["moe_train"]

    def common(name, source):
        skip = {p: n[f"{name}_skip"] for p, n in paths.items()
                if f"{name}_skip" in n}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name], "launches": main_path[name],
                "launches_by_path": {p: n[name] for p, n in paths.items()
                                     if name in n},
                **({"skip_launches_by_path": skip} if skip else {})}

    entries = []
    # The top-level numbers are at the main path's shape; the other shapes
    # (decode, prefill, dlhs, skip, ...) sit beside them under their names.
    for name, main_shape in (("gmm_swiglu", "train"), ("gmm", "train"),
                             ("tgmm", "gate_up")):
        shapes = results[name]
        for rec in shapes.values():
            if "bm" in rec:     # the design each timed shape launched
                rec["variant"] = gm.kernel_variant(name, rec["bm"])
        entries.append({
            **common(name, SOURCE),
            **{k: shapes[main_shape][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()
                               if "max_abs_err" in r),
            "shape": main_shape, "variant": shapes[main_shape]["variant"],
            "designs": {"bm < 64": gm.kernel_variant(name, 1),
                        "bm >= 64": gm.kernel_variant(name, 64)},
            **({"serve_launches_by_design": serve_designs[name],
                "generate_launches_by_design": generate_designs[name]}
               if name in serve_designs else {}),
            **{shape: rec for shape, rec in shapes.items()
               if shape != main_shape},
        })
    for name in FLASH_KERNELS:
        entries.append({**common(name, FLASH_SOURCE), **flash[name]})
    return json.dumps({"kernels": entries})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-phase", default="",
                    help=argparse.SUPPRESS)  # the child of phase 16
    ap.add_argument("--pp-sp-rank", nargs=2, default=None,
                    help=argparse.SUPPRESS)  # a child of phase 22
    ap.add_argument("--pod-phase", default="",
                    help=argparse.SUPPRESS)  # the child of phase 23
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.resume_phase:
        rec = resume_phase(dev, args.seed)
        Path(args.resume_phase).write_text(json.dumps(rec))
        return 0
    if args.pp_sp_rank:
        rank, out = args.pp_sp_rank
        Path(out).write_text(json.dumps(pp_sp_rank(int(rank), dev,
                                                   args.seed)))
        return 0
    if args.pod_phase:
        Path(args.pod_phase).write_text(json.dumps(pod_phase_child()))
        return 0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    cfg = mixtral_8x7b()
    build_phase()
    results = kernel_phase(cfg, dev, args.seed)
    for name, recs in ragged_phase(dev, args.seed).items():
        results.setdefault(name, {})["ragged"] = recs
    for name, recs in moe_kernel_phase(cfg, dev, args.seed,
                                       MOE_TRAIN["batch"],
                                       MOE_TRAIN["seq_len"]).items():
        results.setdefault(name, {}).update(recs)
    flash = flash_phase(dev, args.seed)
    paths = {}
    paths["serve"], serve_designs, backend, scfg = serve_phase(cfg, dev,
                                                               args.seed)
    profile_phase(backend, scfg)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    train_check_phase(dev, args.seed)
    dense_step = train_phase(dev, args.seed)
    paths["dense_train"] = dense_step["launches"]
    moe_train_check_phase(mixtral_8x7b_train(MOE_CHECK["layers"]), dev,
                          args.seed)
    moe_run = moe_train_phase(mixtral_8x7b_train(MOE_TRAIN["layers"]), dev,
                              args.seed)
    paths["moe_train"] = moe_run["launches"]
    remat = remat_phase(dev, args.seed, moe_run["losses"][0])
    for policy, rec in remat.items():
        paths[f"remat_{policy}"] = rec["launches"]
    paths["mesh"] = mesh_phase(dev, remat["full"])["launches"]
    paths["mesh_moe"] = mesh_moe_phase(dev, args.seed, moe_run)["launches"]
    entry_phase()
    paths["mnist"] = mnist_phase(dev)
    paths["resume"] = resume_child(args.seed)["launches"]
    paths["vision"] = vision_phase(dev)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    sp_launches, sp_block = sp_phase(dev, args.seed)
    paths.update(sp_launches)
    for name in FLASH_KERNELS:
        flash[name]["sp_block"] = sp_block[name]
    paths["generate"], generate_designs = generate_phase(dev, args.seed)
    paths.update(pp_phase(dev, args.seed, dense_step))
    entry_hook_phase()
    traced_workloads_phase(args.seed)
    paths["serve_traced"] = traced_serve_phase(dev, args.seed)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    paths.update(pp_sp_phase(args.seed))
    paths["pod"] = pod_phase(args.seed)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    paths["one_program"] = one_program_phase(dev)
    print(card_line())
    print(kernels_line(results, flash, paths, serve_designs,
                       generate_designs))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
