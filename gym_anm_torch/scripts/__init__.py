"""Entry points of the port: the learners' training scripts, the distributed
smoke worker, and the compat tier's controller benchmarks
(``create_algorithmic_diversity``, ``diverse_load_patterns``)."""
