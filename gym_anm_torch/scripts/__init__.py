"""Entry points of the port: the learners' training scripts and the distributed smoke worker."""
