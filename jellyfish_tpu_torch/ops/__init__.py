"""Plain-PyTorch device operations of the counting pipeline."""
