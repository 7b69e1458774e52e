"""The paper's experiments on the port, the counterparts of the reference's
``benchmarks/`` paper scripts, one module each: ``common`` (the Appendix I
problem, the tuned Local baseline, CSVs under ``build/reports/``),
``fig2_erm`` (Figure 2), ``fig3_stochastic`` (Figure 3), ``table1_complexity``
(Table 1), ``delay_bench`` (Theorem 7), ``ablation_mtl_lm`` (the LM
ablation) and ``run`` (the runner, also ``python -m repro_torch.experiments``).
Each module's ``main(argv)`` takes the reference script's arguments plus
``--device`` (CUDA unless given) and returns the rows it prints."""
