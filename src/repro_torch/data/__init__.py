"""Token data (the port of ``repro.data``): ``pipeline``'s synthetic
source and packed, host-sharded, prefetched batches."""
