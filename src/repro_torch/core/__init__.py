"""memtier core, copied from ``repro.core`` (the modules the serving path needs).

profiler    — MemProf analogue (block-access accounting, CDFs, correlation)
distribution— hotness CDF math / Zipf fits / interval stability
tiering     — tier specs, planner, bandwidth-bound throughput model (Table 4/5)
placement   — TPP-like hot/cold placement + migration
prefetch    — software far-tier prefetch engine + accuracy/coverage (Fig 21/22)
pagetable   — ref-counted prefix-shared KV page table (multi-ASID I-TLB analogue)
memtrace    — windowed trace capture + stitch + cache-sim validation (Table 6)
hw          — the card's memory figures + memory-tier specs (not a copy)
"""
