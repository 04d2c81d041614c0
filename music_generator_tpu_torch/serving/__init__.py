from music_generator_tpu_torch.serving.server import (DeepJHTTPServer,
                                                      GenerationService,
                                                      ServiceOverloaded,
                                                      make_handler,
                                                      serve_main)

__all__ = ["DeepJHTTPServer", "GenerationService", "ServiceOverloaded",
           "make_handler", "serve_main"]
