"""Measurement tools of the port: the op-class probe P1 (sm_ceiling.py), the
gather-rate probe, the tail mutants, and the corpus sweep (make_corpus.py,
make_corpus_stats.py, eval_corpus.py, corpus_stats.py)."""
