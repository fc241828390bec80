"""Data: the record readers (`sources`, `align`), host preprocessing,
splits, the synthetic cohort, and materialisation, budgets, the split
cache and streaming (`pipeline`)."""
