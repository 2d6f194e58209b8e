import torch

_HAS_GPU = torch.cuda.is_available()


class Front:
    streams = torch.cuda.device_count()

    def start(self):
        return torch.cuda.current_device()


if __name__ == "__main__":
    torch.cuda.init()
