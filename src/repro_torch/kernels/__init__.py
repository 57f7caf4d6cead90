"""Block-SGD kernel (CUDA, ``csrc/nomad_sgd.cu``), its plain PyTorch
versions, the execution policy and the dispatch."""
