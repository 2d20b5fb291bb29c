"""ANN serving of the port: the int8-plane exact engine (kernel S's SCORE
epilogue + kernel X), the f32 flat inner-product engine, the adaptive
expanding search, validation and the jaccard tool's library half."""
