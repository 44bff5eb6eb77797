"""mxtpu_torch.gluon — the layers and the model zoo as ``nn.Module``s."""
