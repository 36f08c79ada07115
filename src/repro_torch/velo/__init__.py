"""Device-plane pieces of the port.

  device_cache.py — HBM record cache with record_map indirection + vectorized
                    clock second-chance (paper §3.2 on device)
"""
