/* A small JPEG writer on libjpeg(-turbo) for the JPEG codings that Pillow's
 * and cv2's encoders do not write: arithmetic coding (SOF9, SOF10, with or
 * without non-default DAC conditioning), YCCK, custom progressive scan
 * scripts, and (linked against a libjpeg-turbo 3 library, -DLOSSLESS)
 * lossless SOF3. `torch_jpeg_fixtures.py` compiles and runs it; nothing
 * else does.
 *
 *   jpeg_writer in.raw out.jpg WIDTH HEIGHT CHANNELS [key=value ...]
 *
 * in.raw holds HEIGHT x WIDTH x CHANNELS bytes: grey (1), RGB (3) or CMYK
 * (4). Keys:
 *   quality=Q        quantization tables at quality Q (default 90)
 *   space=S          the file's colour space: grey, ycc, rgb, cmyk, ycck
 *                    (default: grey, ycc or cmyk by CHANNELS)
 *   sampling=HxV,..  each component's sampling factors, e.g. 2x2,1x1,1x1
 *   arith=1          arithmetic coding
 *   dac=L,U,K        DC conditioning bounds L and U, AC conditioning K
 *   progressive=1    libjpeg's default progressive scan script
 *   scans=S;S;...    a scan script, each S "c,c,..:Ss:Se:Ah:Al"
 *   restart=N        a restart interval of N MCUs
 *   restart_rows=N   a restart interval of N MCU rows
 *   lossless=PSV,PT  lossless, predictor PSV (1-7), point transform PT
 *   precision=P      lossless sample precision P (2-8; samples below 2**P)
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#ifdef LOSSLESS
void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);
#endif

static jpeg_scan_info scans[64];

static int parse_scans(const char *spec) {
  int n = 0;
  const char *p = spec;
  while (*p && n < 64) {
    jpeg_scan_info *s = &scans[n];
    s->comps_in_scan = 0;
    while (1) {
      s->component_index[s->comps_in_scan++] = (int)strtol(p, (char **)&p, 10);
      if (*p != ',') break;
      ++p;
    }
    if (sscanf(p, ":%d:%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4) {
      fprintf(stderr, "bad scan %d in %s\n", n, spec);
      exit(2);
    }
    ++n;
    p = strchr(p, ';');
    if (!p) break;
    ++p;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s in.raw out.jpg W H C [key=value ...]\n", argv[0]);
    return 2;
  }
  const int w = atoi(argv[3]), h = atoi(argv[4]), c = atoi(argv[5]);
  unsigned char *pix = malloc((size_t)w * h * c);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(pix, 1, (size_t)w * h * c, in) != (size_t)w * h * c) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 2;
  }
  fclose(in);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : c == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);

  int precision = 0, quality = 90, progressive = 0, nscans = 0, psv = 0, pt = 0, restart = 0, restart_rows = 0;
  const char *space = NULL, *sampling = NULL;
  int dac[3] = {-1, -1, -1};
  for (int i = 6; i < argc; ++i) {
    char *eq = strchr(argv[i], '=');
    if (!eq) return 2;
    *eq = 0;
    const char *k = argv[i], *v = eq + 1;
    if (!strcmp(k, "quality")) quality = atoi(v);
    else if (!strcmp(k, "space")) space = v;
    else if (!strcmp(k, "sampling")) sampling = v;
    else if (!strcmp(k, "arith")) cinfo.arith_code = atoi(v) ? TRUE : FALSE;
    else if (!strcmp(k, "dac")) sscanf(v, "%d,%d,%d", &dac[0], &dac[1], &dac[2]);
    else if (!strcmp(k, "progressive")) progressive = atoi(v);
    else if (!strcmp(k, "scans")) nscans = parse_scans(v);
    else if (!strcmp(k, "restart")) restart = atoi(v);
    else if (!strcmp(k, "restart_rows")) restart_rows = atoi(v);
    else if (!strcmp(k, "lossless")) sscanf(v, "%d,%d", &psv, &pt);
    else if (!strcmp(k, "precision")) precision = atoi(v);
    else {
      fprintf(stderr, "unknown key %s\n", k);
      return 2;
    }
  }
  if (space) {
    J_COLOR_SPACE cs = !strcmp(space, "grey") ? JCS_GRAYSCALE
                     : !strcmp(space, "ycc")  ? JCS_YCbCr
                     : !strcmp(space, "rgb")  ? JCS_RGB
                     : !strcmp(space, "cmyk") ? JCS_CMYK
                     : !strcmp(space, "ycck") ? JCS_YCCK
                                              : JCS_UNKNOWN;
    if (cs == JCS_UNKNOWN) return 2;
    jpeg_set_colorspace(&cinfo, cs);
  }
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (sampling) {
    const char *p = sampling;
    for (int ci = 0; ci < cinfo.num_components && *p; ++ci) {
      int hs, vs;
      if (sscanf(p, "%dx%d", &hs, &vs) != 2) return 2;
      cinfo.comp_info[ci].h_samp_factor = hs;
      cinfo.comp_info[ci].v_samp_factor = vs;
      p = strchr(p, ',');
      if (!p) break;
      ++p;
    }
  }
  if (dac[0] >= 0)
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      cinfo.arith_dc_L[t] = (UINT8)dac[0];
      cinfo.arith_dc_U[t] = (UINT8)dac[1];
      cinfo.arith_ac_K[t] = (UINT8)dac[2];
    }
  if (progressive) jpeg_simple_progression(&cinfo);
  if (nscans) {
    cinfo.scan_info = scans;
    cinfo.num_scans = nscans;
  }
  cinfo.restart_interval = restart;
  cinfo.restart_in_rows = restart_rows;
  if (psv) {
#ifdef LOSSLESS
    jpeg_enable_lossless(&cinfo, psv, pt);
    if (precision) cinfo.data_precision = precision;
#else
    fprintf(stderr, "built without lossless support\n");
    return 2;
#endif
  }

  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pix + (size_t)cinfo.next_scanline * w * c;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pix);
  return 0;
}
