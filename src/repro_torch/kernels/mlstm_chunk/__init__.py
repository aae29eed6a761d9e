"""mLSTM chunkwise forward (replaces ``repro/kernels/mlstm_chunk``)."""
