"""PyTorch/CUDA port of the FaaSLight serving pipeline (``repro`` is the JAX
reference it is held against).

The port keeps the reference's module names and layout so every module has
an obvious counterpart. It imports ``torch`` and never ``jax``; entry points
run on ``cuda`` unless the caller passes ``device="cpu"``. Ported so far: the
serving pipeline — configs → analyze → ``build_artifact`` /
``write_monolithic`` → ``cold_start(mode="before"|"after1"|"after2")`` under
the strict, stats and full residency policies (``core/prefetch``'s
prefetcher) → ``GenerationEngine.generate`` or the continuous-batching
``serving/scheduler``, over a warm set of compiled entries (CUDA graphs on
the card), and its launcher's one-shot and traffic modes (``launch/serve``)
— for the Mixtral family and RecurrentGemma, with
prefill attention and the RG-LRU scan in hand-written CUDA kernels
(``kernels/flash_attention``, ``kernels/rglru_scan``); the model layer's paged-KV decode
(``serving/paged_kv.PagePool``, ``models/attention.paged_gqa_decode``)
through the paged decode kernel (``kernels/decode_attention``); and the
dense decode and tiered gather kernels as ops (``kernels/decode_attention``,
``kernels/tiered_gather``) that, as in the reference, no served path calls;
the training round trip (``optim``, ``checkpoint``, ``training``); and the
device mesh (``sharding``, ``launch/mesh``) that shards serving and training
over ``torch.distributed``'s ``DeviceMesh``.
"""
