"""Model towers in PyTorch (BERT and DistilBERT, ``models.bert``)."""
