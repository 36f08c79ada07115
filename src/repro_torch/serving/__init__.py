"""LM serving substrate: the paper's buffer-pool ideas applied to KV caches.

  kv_pool.py   — paged KV block pool: record_map-style indirection (a block
                 table per request), clock second-chance eviction across
                 requests (paper C2 -> KV pages); the page tensors live on
                 the pool's device, the swap store on the host
  scheduler.py — continuous batching with cache-aware admission: runnable
                 requests whose KV blocks are resident are scheduled first
                 (paper C5 -> decode scheduling)
"""
