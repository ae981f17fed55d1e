"""CAPSim core, PyTorch port.

    standardize    instruction -> structured token sequence (copy)
    context        architectural register state -> context matrix (copy)
    engine_config  the one engine construction surface (copy)
    slicer         clip slicing, Algorithm 1 (copy)
    analytical     per-clip analytical features and the fused estimator
                   of the sampled path (copy)
    sampler        the occurrence and stratified clip samplers (copy)
    intervals      SimPoint interval selection (copy)
    predictor      the attention performance predictor on torch tensors
    quant          int8 per-channel weight fake-quantization
    rt_cache       static-instruction RT table on the device
    engine         batched multi-benchmark simulation engine
    simulate       single-benchmark wrapper over the engine
"""
