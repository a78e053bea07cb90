"""QuickVC networks in PyTorch, reference state_dict layout."""
