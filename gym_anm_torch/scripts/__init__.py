"""Entry points of the port: the learners' training scripts, the distributed
smoke worker, the compat tier's controller benchmarks
(``create_algorithmic_diversity``, ``diverse_load_patterns``), the offline
dataset scripts (``generate_final_offline_datasets``,
``quick_dataset_test``), the L0-L5 quality table, the RTI budget sweep, the
weak-scaling bench and the verification drive (``verify_h100``)."""
