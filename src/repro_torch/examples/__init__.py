"""The reference's five ``examples/`` on the port, one module each, run as
``python -m repro_torch.examples.<name> [--device cpu]``: ``quickstart``,
``consensus_vs_multitask``, ``learn_the_graph``, ``train_multitask_lm`` and
``serve_batched``. Each ``main(argv=None)`` prints what the reference script
prints and returns the numbers it prints. They run on CUDA unless
``--device`` names another device; without a GPU they raise."""
