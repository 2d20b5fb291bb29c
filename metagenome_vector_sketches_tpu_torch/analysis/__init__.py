"""Analysis & export utilities: estimator accuracy simulation, PCA cluster
plots, matrix interpretation/histograms, COO export."""
